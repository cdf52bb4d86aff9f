"""The plain reference: YOLACT with a ResNet-50 or Swin-T backbone, its
decode, fast NMS, mask finalize, matcher, four losses, SGD and AdamW, in
plain float32 PyTorch. It imports nothing of the program under test; it is
handed the benchmark's weights and inputs and works out everything else
again."""
