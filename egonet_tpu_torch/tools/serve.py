"""Serve the fused EgoNet pipeline over HTTP with micro-batching, on the
card (port of ``tools/serve.py``; see ``egonet_tpu_torch/serving``).

    python -m egonet_tpu_torch.tools.serve --cfg <yaml> \\
        [--host 127.0.0.1] [--port 8476] [--max-batch 16] [--max-wait-ms 10]

Then:
  curl -s localhost:8476/healthz
  curl -s -X POST localhost:8476/v1/pose -d '{"image_path": ".../000001.png",
       "boxes": [[446.9, 201.7, 545.7, 300.2]],
       "K": [[707.0, 0, 604.0], [0, 707.0, 180.0], [0, 0, 1]]}'

The model runs on CUDA unless the config says ``device: cpu``.  On a host
without PyYAML, call ``main(argv, cfgs=<dict>)``; ``block=False`` returns
the started server instead of serving until interrupted.
"""

from __future__ import annotations

import argparse
import logging
import threading


def main(argv=None, cfgs=None, block: bool = True):
    """Boot the server from ``argv`` (and ``cfgs``, a config dict, in place
    of ``--cfg``); serve until interrupted, or return the started server
    when ``block`` is false."""
    parser = argparse.ArgumentParser(description="EgoNet pose server")
    parser.add_argument("--cfg", help="inference yaml (or main(cfgs=...))")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8476)
    parser.add_argument("--max-batch", type=int, default=16,
                        help="images per micro-batch")
    parser.add_argument("--max-wait-ms", type=float, default=10.0,
                        help="max linger after the first queued request")
    parser.add_argument("--idle-floor", type=int, default=16,
                        help="instance bucket for uncongested micro-batches "
                             "(the 128 congestion floor applies under load); "
                             "0 always uses the 128 floor")
    parser.add_argument("--alpha-mode", default="proj",
                        choices=("proj", "trans"))
    parser.add_argument("--warmup", type=int, default=1,
                        help="1: build the kernels and run both serving "
                             "buckets at boot")
    parser.add_argument("--devices", type=int, default=1,
                        help="cards to shard each micro-batch over (only 1 "
                             "is ported)")
    args = parser.parse_args(argv)
    if args.devices > 1:
        raise NotImplementedError(
            "--devices > 1 (micro-batches sharded over several cards) is "
            "not ported yet: it comes with parallel/mesh.py, the "
            "scale-out slice queued in ROADMAP.md")
    from egonet_tpu_torch import config as cfg_mod
    from egonet_tpu_torch.models.egonet import EgoNet
    from egonet_tpu_torch.serving import PoseServer
    if cfgs is None:
        if not args.cfg:
            parser.error("--cfg is required")
        cfgs = cfg_mod.load_config(args.cfg)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    logger = logging.getLogger("egonet-serve")
    # same checkpoint and precision policy as the inference CLI
    model = EgoNet(cfgs, pre_trained=cfgs.get("pre_trained", True),
                   dtype=cfg_mod.config_dtype(cfgs), device=cfgs.get("device"))
    server = PoseServer(model, host=args.host, port=args.port,
                        max_images=args.max_batch,
                        max_wait_ms=args.max_wait_ms,
                        alpha_mode=args.alpha_mode,
                        idle_floor=args.idle_floor).start()
    if args.warmup:
        logger.info("warmup: building the kernels, running both buckets")
        try:
            server.warmup()
        except BaseException:
            server.stop()
            raise
        logger.info("warmup done")
    logger.info("serving on http://%s:%d (%s; micro-batch <= %d, linger "
                "%.1f ms)", args.host, server.port, server.device,
                args.max_batch, args.max_wait_ms)
    if not block:
        return server
    try:
        threading.Event().wait()                     # until interrupted
    except KeyboardInterrupt:
        logger.info("shutting down")
    finally:
        server.stop()
    return server


if __name__ == "__main__":
    main()
