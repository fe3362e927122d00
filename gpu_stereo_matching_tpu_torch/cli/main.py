"""Command line of the port: the ``st``, ``bm`` and ``middlebury`` subcommands.

``st`` is the reference's STMatching CLI (``STMatching/main.cpp:40-67``):
a BGR pair in, the ST-1 (``--method st1``, the default) or ST-2
(``--method st2``) disparity scaled by ``--scale`` out as a PNG.

``bm`` is the reference's BlockMatching ``singleFrame`` demo: two images
in, a scaled (or, with ``--colorize``, turbo-colored) disparity PNG out.
Without ``--fused`` the unfused path runs, with the ``--lr-check`` and
``--median-radius`` post-filters; ``--fused`` runs the fused SAD + WTA
kernel (its plain twin on ``--device cpu``) and, as in the JAX package,
ignores the post-filters. It runs on the card (``--device cuda``, the
default) and raises where there is none; ``--device cpu`` runs the plain
torch versions.

``middlebury`` runs the accuracy harness (``bench/middlebury.py``) over a
directory of Middlebury scenes and prints each pipeline's bad-2.0 per
scene, then their mean. Unlike the JAX command, ``--root`` has no default.

Run: ``python -m gpu_stereo_matching_tpu_torch.cli.main st L.png R.png out.png``
or ``python -m gpu_stereo_matching_tpu_torch.cli.main bm L.png R.png out.png --lr-check --median-radius 3``
or ``python -m gpu_stereo_matching_tpu_torch.cli.main middlebury --root DIR --pipelines bm,bm+,st1,st2``
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def _cmd_st(args) -> int:
    from gpu_stereo_matching_tpu_torch.core.config import SegmentTreeConfig
    from gpu_stereo_matching_tpu_torch.io.images import load_image_bgr, save_image
    from gpu_stereo_matching_tpu_torch.models.segment_tree import segment_tree_disparity

    cfg = SegmentTreeConfig(
        max_disp_levels=args.max_disp,
        disparity_scale=args.scale,
        sigma=args.sigma,
        iterate=(args.method == "st2"),
    )
    left = load_image_bgr(args.left)
    right = load_image_bgr(args.right)
    disp = segment_tree_disparity(left, right, cfg, device=args.device).cpu().numpy()
    save_image(args.out, disp)
    print(f"wrote {args.out} ({disp.shape[1]}x{disp.shape[0]}, scale {args.scale})")
    return 0


def _cmd_bm(args) -> int:
    from gpu_stereo_matching_tpu_torch.core.config import BlockMatchingConfig
    from gpu_stereo_matching_tpu_torch.io.images import load_image_bgr, load_image_gray, save_image
    from gpu_stereo_matching_tpu_torch.device import resolve_device
    from gpu_stereo_matching_tpu_torch.kernels.gray import gray_blockmatching_bgr
    from gpu_stereo_matching_tpu_torch.kernels.sad_wta import fused_block_matching
    from gpu_stereo_matching_tpu_torch.models.block_matching import block_matching_pipeline

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


def _cmd_middlebury(args) -> int:
    from gpu_stereo_matching_tpu_torch.bench.middlebury import run_middlebury_suite

    results = run_middlebury_suite(
        args.root,
        pipelines=args.pipelines.split(","),
        scenes=args.scenes.split(",") if args.scenes else None,
        device=args.device,
    )
    with_gt = [r for r in results if r.bad2 is not None]
    if with_gt:
        mean = float(np.mean([r.bad2 for r in with_gt]))
        print(f"mean bad-2.0 over {len(with_gt)} runs: {100 * mean:.2f}%")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gpu_stereo_matching_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    st = sub.add_parser("st", help="segment-tree stereo (ST-1 / ST-2)")
    st.add_argument("left")
    st.add_argument("right")
    st.add_argument("out")
    st.add_argument("--max-disp", type=int, default=60)
    st.add_argument("--scale", type=int, default=4)
    st.add_argument("--sigma", type=float, default=0.1)
    st.add_argument("--method", choices=["st1", "st2"], default="st1")
    st.add_argument("--device", default="cuda", help="cuda (the default), cuda:N or cpu")
    st.set_defaults(fn=_cmd_st)

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

    mb = sub.add_parser("middlebury", help="dataset sweep with bad-2.0")
    mb.add_argument("--root", required=True,
                    help="directory of scene folders (view1.png, view5.png, disp1.png, ...)")
    mb.add_argument("--pipelines", default="bm,st1", help="comma-separated: bm, bm+, st1, st2, "
                    "opencv-bm, opencv-sgbm")
    mb.add_argument("--scenes", default=None, help="comma-separated scene names (default: "
                    "every scene with ground truth)")
    mb.add_argument("--device", default="cuda", help="cuda (the default), cuda:N or cpu")
    mb.set_defaults(fn=_cmd_middlebury)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
