"""Dataset command-line tools, run as `python -m yolact_minimal_torch.tools.<name>`:
labelme2coco, pascal2coco, make_custom_dataset, view_annotations."""
