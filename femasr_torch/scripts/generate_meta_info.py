"""Write a meta-info file: one line `relative/path (h,w,c)` per image under
a folder (counterpart of scripts/data_preparation/generate_meta_info.py).

    python -m femasr_torch.scripts.generate_meta_info \
        --input ../datasets/HQ_sub --meta_info ../datasets/meta_info.txt
"""

import argparse
from os import path as osp

from ..data.data_util import make_dataset

CHANNELS = {'RGB': 3, 'L': 1, 'RGBA': 4}


def main(argv=None) -> None:
    from PIL import Image
    parser = argparse.ArgumentParser()
    parser.add_argument('--input', type=str, required=True)
    parser.add_argument('--meta_info', type=str, required=True)
    args = parser.parse_args(argv)
    with open(args.meta_info, 'w') as f:
        for idx, p in enumerate(make_dataset(args.input)):
            with Image.open(p) as img:
                width, height = img.size
                n_channel = CHANNELS.get(img.mode, 3)
            info = (f'{osp.relpath(p, args.input)} '
                    f'({height},{width},{n_channel})')
            print(idx + 1, info)
            f.write(f'{info}\n')


if __name__ == '__main__':
    main()
