"""Quantize once, serve many: turn a checkpoint into an int8 serving
artifact (the w8a8 scheme of ``fit_tpu_torch.ops.quant``) that the sample
and serve command lines load without a conversion pass.

    python -m fit_tpu_torch.cli.quantize --checkpoint-path results/checkpoints \\
        --output results/quantized [--model FiT-XL/2] [--equalize 2]
    python -m fit_tpu_torch.cli.quantize --torch-checkpoint last.ckpt --output ...
    python -m fit_tpu_torch.cli.serve --checkpoint-path results/quantized ...

Writes ``params.pt`` and ``quant.json`` (``save_quantized``) and the
sampling ``config.json`` beside them. ``--equalize N`` runs SmoothQuant on N
synthetic calibration batches first. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from fit_tpu_torch.cli.sample import load_model_and_params, read_config

__all__ = ["main"]


def main(argv=None) -> str:
    """Run the command line; returns the artifact's directory."""
    parser = argparse.ArgumentParser(description="Convert a FiT checkpoint to an int8 serving artifact")
    parser.add_argument("--torch-checkpoint", type=str, default=None,
                        help="quantize a reference (PyTorch Lightning) FiT checkpoint")
    parser.add_argument("--output", type=str, required=True, help="directory for the artifact")
    parser.add_argument("--equalize", type=int, default=0, metavar="N",
                        help="SmoothQuant on N synthetic calibration batches first (0: off)")
    args, cfg = read_config(parser, argv)

    from fit_tpu_torch.ops.quant import save_quantized

    model = load_model_and_params(
        cfg, torch_checkpoint=args.torch_checkpoint, quant="int8", equalize=args.equalize, device=args.device
    )
    save_quantized(
        args.output, model.state_dict(),
        meta={"model": cfg.model, "num_classes": cfg.num_classes, "use_ema": cfg.use_ema,
              "equalized_batches": args.equalize},
    )
    # the sampling config rides along, so sample and serve restore it as
    # they do from a Trainer's results directory
    with open(os.path.join(args.output, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)
    print(f"Wrote int8 serving artifact to {args.output}")
    return args.output


if __name__ == "__main__":
    main()
