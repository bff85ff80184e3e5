"""Export the fused inference program as ``torch.export`` artifacts (port
of ``tools/export_model.py``; see ``egonet_tpu_torch/io/export.py``).

Traces the canvas-mode program for each instance bucket and writes one
weight-agnostic ``.pt2`` per bucket plus ``manifest.json``.

    python -m egonet_tpu_torch.tools.export_model --cfg <yaml> \\
        --out <dir> [--buckets 8,16,32,64,128] [--alpha-mode proj] \\
        [--n-img 16]

The program is traced on CUDA (so the graph launches the fused kernels
there) unless the config says ``device: cpu``.  On a host without PyYAML,
call ``main(argv, cfgs=<dict>)``.
"""

from __future__ import annotations

import argparse


def main(argv=None, cfgs=None) -> dict:
    """Export and print one summary line; returns the manifest."""
    parser = argparse.ArgumentParser(
        description="AOT-export the fused EgoNet program")
    parser.add_argument("--cfg", help="inference yaml (or main(cfgs=...))")
    parser.add_argument("--out", required=True)
    parser.add_argument("--buckets", default="8,16,32,64,128")
    parser.add_argument("--alpha-mode", default="proj",
                        choices=("proj", "trans"))
    parser.add_argument("--n-img", type=int, default=16)
    args = parser.parse_args(argv)

    from egonet_tpu_torch import config as cfg_mod
    from egonet_tpu_torch.io import export as export_mod
    from egonet_tpu_torch.models.egonet import EgoNet
    if cfgs is None:
        if not args.cfg:
            parser.error("--cfg is required")
        cfgs = cfg_mod.load_config(args.cfg)
    model = EgoNet(cfgs, pre_trained=cfgs.get("pre_trained", False),
                   dtype=cfg_mod.config_dtype(cfgs), device=cfgs.get("device"))
    manifest = export_mod.export_shape_set(
        model, args.out,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        n_img=args.n_img, alpha_mode=args.alpha_mode)
    total = sum(e["bytes"] for e in manifest["artifacts"].values())
    print(f"exported {len(manifest['artifacts'])} programs "
          f"({total / 1e6:.1f} MB, {manifest['device']}) -> {args.out}")
    return manifest


if __name__ == "__main__":
    main()
