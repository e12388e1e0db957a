"""Pack an image folder into a `.fmrs` shard for training (counterpart of
scripts/data_preparation/create_shard.py).

    python -m femasr_torch.scripts.create_shard \
        --input ../datasets/HQ_sub --output ../datasets/HQ_sub.fmrs
"""

import argparse

from ..data.shardstore import make_shard_from_folder


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument('--input', type=str, required=True)
    parser.add_argument('--output', type=str, required=True,
                        help='output .fmrs path')
    args = parser.parse_args(argv)
    n = make_shard_from_folder(args.input, args.output)
    print(f'packed {n} images into {args.output}')


if __name__ == '__main__':
    main()
