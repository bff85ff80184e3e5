"""Profile the port's device program (``EgoNet._core``) and print where the
time goes: by kernel category, by facade stage (``utils/profiling.SPANS``),
the top kernels and the device's idle gaps (port of
``tools/profile_model.py``, inference mode).

    python -m egonet_tpu_torch.tools.profile_model [--cfg <yaml>]
        [--batch 384] [--iters 2] [--trace-dir DIR]

Three warm steps, then ``--iters`` traced steps on inputs already on the
card (the root bench's inputs, ``tools/bench.build_core_inputs``).  The
Chrome trace stays in ``--trace-dir`` for Perfetto.  Without ``--cfg`` it
runs the shipped W48 config; without PyYAML call ``main(cfgs=...)``.
``--train`` (IGR training, ROADMAP slice C) is not ported yet.
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None, cfgs=None, device=None) -> dict:
    """Returns ``utils/profiling.summarize_trace``'s dict."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", default=None)
    parser.add_argument("--train", action="store_true",
                        help="profile one stage-2 training step (not "
                             "ported yet)")
    parser.add_argument("--batch", type=int, default=384,
                        help="instance count")
    parser.add_argument("--trace-dir", default="egonet_profile")
    parser.add_argument("--iters", type=int, default=2)
    args = parser.parse_args(argv)
    if args.train:
        raise NotImplementedError(
            "--train profiles IGR training, which is not ported yet "
            "(ROADMAP slice C)")

    from egonet_tpu_torch import config
    from egonet_tpu_torch.models.egonet import EgoNet
    from egonet_tpu_torch.tools.bench import build_core_inputs
    from egonet_tpu_torch.utils import profiling
    if cfgs is None:
        cfgs = (config.load_config(args.cfg) if args.cfg
                else config.demo_config())
    model = EgoNet(cfgs, pre_trained=False, device=device)
    dev_args = build_core_inputs(model, args.batch)

    def step():
        out = model._core(*dev_args, alpha_mode="proj")
        float(out[-1, -2])                    # waits for the device

    with torch.inference_mode():
        for _ in range(3):
            step()
        with profiling.trace(args.trace_dir, model.device):
            for _ in range(args.iters):
                step()
    summary = profiling.summarize_trace(args.trace_dir, iters=args.iters)
    print(summary["text"])
    print(f"trace: {args.trace_dir}/{profiling.TRACE_FILE}")
    return summary


if __name__ == "__main__":
    main()
