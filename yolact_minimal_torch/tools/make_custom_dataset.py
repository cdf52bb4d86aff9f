"""Generate the synthetic COCO-format shapes dataset that the res50_custom /
res101_custom configs read.

    python -m yolact_minimal_torch.tools.make_custom_dataset [--root custom_dataset]
        [--num_images 12] [--img_size 448] [--seed 0]

Writes ROOT/images/*.jpg, ROOT/annotations.json and ROOT/labels.txt
(data/synthetic.py); --num_images 48 writes the repository's custom_dataset/.
Needs cv2.
"""
import argparse
import os

from yolact_minimal_torch.data.synthetic import generate_dataset


def main(argv=None):
    p = argparse.ArgumentParser(description='Synthetic COCO-format shapes dataset')
    p.add_argument('--root', default='custom_dataset')
    p.add_argument('--num_images', type=int, default=12)
    p.add_argument('--img_size', type=int, default=448)
    p.add_argument('--seed', type=int, default=0)
    args = p.parse_args(argv)

    img_dir, ann = generate_dataset(args.root, num_images=args.num_images,
                                    img_size=args.img_size, num_classes=4,
                                    seed=args.seed)
    with open(os.path.join(args.root, 'labels.txt'), 'w') as f:
        f.write('background\n' + '\n'.join(f'shape{i}' for i in range(4)) + '\n')
    print(f'Wrote {args.num_images} images to {img_dir}, annotations to {ann}')


if __name__ == '__main__':
    main()
