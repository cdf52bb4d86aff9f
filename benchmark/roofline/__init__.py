"""The benchmark's own counts: the card's peaks, the model's operations by
FlopCounterMode on the meta device, and each kernel's bound from its launch
shapes."""
