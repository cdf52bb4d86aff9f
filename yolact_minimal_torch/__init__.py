"""PyTorch/CUDA port of yolact_minimal_tpu: res50/res101 YOLACT detect with
hand-written CUDA kernels for NMS suppression and mask finalize."""
