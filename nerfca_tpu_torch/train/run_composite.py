"""CLI driver for the composite 4-D method on PyTorch/CUDA:

    python -m nerfca_tpu_torch.train.run_composite --config configs/composite.txt --use_pallas true
    python -m nerfca_tpu_torch.train.run_composite --config ... --only_prepare_data true

``--platform cpu`` runs on the CPU (plain torch in place of the kernels).
``--wandb_sweep_yaml <yaml>`` runs a sweep of ``train_composite`` over the yaml's
grid (``train/sweep.py``: wandb's agent with ``--use_wandb true`` when
wandb is importable, else the local grid / hyperband executor).
"""

from __future__ import annotations

import torch

from nerfca_tpu_torch.data.dataset import build_dataset
from nerfca_tpu_torch.train.config import parse_args
from nerfca_tpu_torch.train.sweep import run_sweep
from nerfca_tpu_torch.train.trainer import resolve_device, train_composite


def main(argv=None):
    args = parse_args(argv)
    if args.only_prepare_data:
        print("NOT TRAINING, JUST PREPROCESSING DATA")
        build_dataset(args, args.data_root, device=resolve_device(args.platform))
        return None
    if args.wandb_sweep_yaml:
        return run_sweep(args, train_composite)
    if args.debug_mode:
        print("DEBUG MODE ON")
        with torch.autograd.detect_anomaly():
            return train_composite(args)
    return train_composite(args)


if __name__ == "__main__":
    main()
