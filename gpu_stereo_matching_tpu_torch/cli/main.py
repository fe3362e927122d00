"""Command line of the port: the ``bm`` subcommand.

``bm`` is the reference's BlockMatching ``singleFrame`` demo: two images
in, a scaled (or, with ``--colorize``, turbo-colored) disparity PNG out.
Without ``--fused`` the unfused path runs, with the ``--lr-check`` and
``--median-radius`` post-filters; ``--fused`` runs the fused SAD + WTA
kernel (its plain twin on ``--device cpu``) and, as in the JAX package,
ignores the post-filters. It runs on the card (``--device cuda``, the
default) and raises where there is none; ``--device cpu`` runs the plain
torch versions.

Run: ``python -m gpu_stereo_matching_tpu_torch.cli.main bm L.png R.png out.png --lr-check --median-radius 3``
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def _cmd_bm(args) -> int:
    from gpu_stereo_matching_tpu_torch.core.config import BlockMatchingConfig
    from gpu_stereo_matching_tpu_torch.io.images import load_image_bgr, load_image_gray, save_image
    from gpu_stereo_matching_tpu_torch.device import resolve_device
    from gpu_stereo_matching_tpu_torch.kernels.sad_wta import fused_block_matching
    from gpu_stereo_matching_tpu_torch.models.block_matching import block_matching_pipeline
    from gpu_stereo_matching_tpu_torch.ops.color import gray_blockmatching_bgr

    device = resolve_device(args.device)

    def load_gray(path):
        if args.gray:
            return torch.tensor(load_image_gray(path), device=device)
        return gray_blockmatching_bgr(torch.tensor(load_image_bgr(path), device=device))

    left, right = load_gray(args.left), load_gray(args.right)
    if args.fused:
        disp = fused_block_matching(left, right, args.disparities, args.radius)
    else:
        cfg = BlockMatchingConfig(
            num_disparities=args.disparities,
            sad_radius=args.radius,
            lr_consistency=args.lr_check,
            median_radius=args.median_radius,
        )
        disp = block_matching_pipeline(left, right, cfg)
    out = disp.cpu().numpy()
    if args.colorize:
        from gpu_stereo_matching_tpu_torch.io.visualize import colorize_disparity

        save_image(args.out, colorize_disparity(out, args.disparities))
    else:
        save_image(args.out, np.clip(out * args.scale, 0, 255).astype(np.uint8))
    print(f"wrote {args.out} (max disparity {int(out.max())})")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gpu_stereo_matching_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    bm = sub.add_parser("bm", help="SAD block matching")
    bm.add_argument("left")
    bm.add_argument("right")
    bm.add_argument("out")
    bm.add_argument("--disparities", type=int, default=64)
    bm.add_argument("--radius", type=int, default=5)
    bm.add_argument("--scale", type=int, default=4)
    bm.add_argument("--gray", action="store_true", help="inputs already gray")
    bm.add_argument("--fused", action="store_true",
                    help="use the fused kernel (ignores --lr-check and --median-radius)")
    bm.add_argument("--lr-check", action="store_true", help="left-right consistency")
    bm.add_argument("--median-radius", type=int, default=0)
    bm.add_argument("--colorize", action="store_true", help="turbo-colormap output")
    bm.add_argument("--device", default="cuda", help="cuda (the default), cuda:N or cpu")
    bm.set_defaults(fn=_cmd_bm)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
