"""The modules that no run of the benchmark may load: JAX and the JAX
package, compared by each loaded module's whole top-level name."""
from __future__ import annotations

import sys
from typing import List

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'yolact_minimal_tpu')


def forbidden_loaded(modules=None) -> List[str]:
    names = sys.modules if modules is None else modules
    tops = {name.split('.', 1)[0] for name in names}
    return sorted(tops & set(FORBIDDEN))
