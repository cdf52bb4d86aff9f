"""The harness's general parts: finding a cell's files, weights and traffic
from the seed, the timed window, the trace reader and the comparison."""
