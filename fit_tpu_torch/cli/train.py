"""Training command line, with ``fit_tpu``'s flags.

    python -m fit_tpu_torch.cli.train --model FiT-B/2 --feature-path <latents> \
        --global-batch-size 128 [--epochs 100] [--config cfg.json] [--device cuda]

Trains on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

from fit_tpu_torch.utils.config import TrainConfig, add_dataclass_args, from_args


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train a FiT model with fit_tpu_torch")
    parser.add_argument("--config", type=str, default=None, help="JSON config file")
    parser.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    add_dataclass_args(parser, TrainConfig)
    args = parser.parse_args(argv)
    cfg = from_args(TrainConfig, args, args.config)

    from fit_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg, device=args.device)
    return trainer.fit(max_steps=cfg.max_steps or None)


if __name__ == "__main__":
    main()
