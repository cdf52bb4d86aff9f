"""PyTorch/CUDA port of yolact_minimal_tpu: YOLACT detection on images and
video, evaluation, training and export (res50, res101, swin_tiny) with
hand-written CUDA kernels for NMS suppression, mask finalize and the four
swin block kernels; the swin kernels are registered operators that an
exported program calls."""
