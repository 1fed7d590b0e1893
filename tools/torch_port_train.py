"""Train the PyTorch/CUDA port from a config, on the GPU (counterpart of
`tools/train.py`):

    python3 tools/torch_port_train.py --config-file configs/scannet/semseg-pt-v3m1-0-base.py \
        --options save_path=exp/debug

One process on one card. Raises when no CUDA device is present."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pointcept_tpu_torch.engines import default_argument_parser, default_config_parser, main_worker  # noqa: E402


def main():
    args = default_argument_parser().parse_args()
    main_worker(default_config_parser(args.config_file, args.options))


if __name__ == "__main__":
    main()
