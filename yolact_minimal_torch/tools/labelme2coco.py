"""labelme jsons + labels.txt -> one COCO json.

    python -m yolact_minimal_torch.tools.labelme2coco --img_dir DIR --label_name labels.txt
        [--img_type jpg]

Writes DIR/custom_ann.json (data/converters.py::labelme_to_coco); needs cv2.
"""
import argparse

from yolact_minimal_torch.data.converters import labelme_to_coco


def main(argv=None):
    p = argparse.ArgumentParser(description='labelme annotations -> COCO json')
    p.add_argument('--img_dir', required=True, help='Annotated directory.')
    p.add_argument('--label_name', required=True, help='labels.txt path.')
    p.add_argument('--img_type', default='jpg')
    args = p.parse_args(argv)
    out = labelme_to_coco(args.img_dir, args.label_name, args.img_type)
    print(f'Saved in: {out}')


if __name__ == '__main__':
    main()
