"""Pascal-SBD .mat annotations -> COCO jsons.

    python -m yolact_minimal_torch.tools.pascal2coco --folder_path SBD

Writes SBD/pascal_sbd_train.json and SBD/pascal_sbd_val.json
(data/converters.py::pascal_sbd_to_coco); needs cv2 and scipy.
"""
import argparse

from yolact_minimal_torch.data.converters import pascal_sbd_to_coco


def main(argv=None):
    p = argparse.ArgumentParser(description='Pascal-SBD annotations -> COCO jsons')
    p.add_argument('--folder_path', required=True,
                   help='The path of the pascal_sbd folder.')
    args = p.parse_args(argv)
    for out in pascal_sbd_to_coco(args.folder_path):
        print(f'Wrote {out}')


if __name__ == '__main__':
    main()
