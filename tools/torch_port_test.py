"""Test the PyTorch/CUDA port from a config, on the GPU (counterpart of
`tools/test.py`): the config's tester (`SemSegTester`: every test-time view,
fragment voting at full resolution, mIoU / mAcc / allAcc, `_pred.npy` files
and `record.npz` under ``save_path/result``) on the weights of ``weight``:

    python3 tools/torch_port_test.py --config-file configs/scannet/semseg-pt-v3m1-0-base.py \
        --options save_path=exp/debug weight=exp/debug/model/model_best.pth

One process on one card. Raises when no CUDA device is present; from
Python, `main_worker(cfg, device="cpu")` runs the plain versions on the
CPU."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pointcept_tpu_torch.engines import default_argument_parser, default_config_parser  # noqa: E402
from pointcept_tpu_torch.engines.test import main_worker  # noqa: E402

__all__ = ["main_worker"]


def main():
    args = default_argument_parser().parse_args()
    main_worker(default_config_parser(args.config_file, args.options))


if __name__ == "__main__":
    main()
