"""Serve the fused EgoNet pipeline over HTTP with micro-batching, on the
card (port of ``tools/serve.py``; see ``egonet_tpu_torch/serving``).

    python -m egonet_tpu_torch.tools.serve --cfg <yaml> \\
        [--host 127.0.0.1] [--port 8476] [--max-batch 16] [--max-wait-ms 10]
        [--devices N]

Then:
  curl -s localhost:8476/healthz
  curl -s -X POST localhost:8476/v1/pose -d '{"image_path": ".../000001.png",
       "boxes": [[446.9, 201.7, 545.7, 300.2]],
       "K": [[707.0, 0, 604.0], [0, 707.0, 180.0], [0, 0, 1]]}'

The model runs on CUDA unless the config says ``device: cpu``.
``--devices N`` shards each micro-batch's instances over the first N cards
(``parallel/mesh.make_mesh``; an error when fewer are visible, and on the
CPU).  On a host without PyYAML, call ``main(argv, cfgs=<dict>)``;
``block=False`` returns the started server instead of serving until
interrupted.
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
                        help="shard each micro-batch's instances over the "
                             "first N cards (one process, a replica of the "
                             "models on each card)")
    args = parser.parse_args(argv)
    from egonet_tpu_torch import config as cfg_mod
    from egonet_tpu_torch.models.egonet import EgoNet
    from egonet_tpu_torch.serving import PoseServer
    if cfgs is None:
        if not args.cfg:
            parser.error("--cfg is required")
        cfgs = cfg_mod.load_config(args.cfg)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    logger = logging.getLogger("egonet-serve")
    data_mesh = None
    if args.devices > 1:
        from egonet_tpu_torch.parallel import mesh
        if cfgs.get("device") not in (None, "cuda"):
            parser.error(f"--devices {args.devices} shards over cards; the "
                         f"config's device is {cfgs.get('device')!r}")
        try:
            data_mesh = mesh.make_mesh(args.devices)
        except ValueError as exc:
            parser.error(str(exc))
        logger.info("sharding micro-batches over %s", data_mesh)
    # same checkpoint and precision policy as the inference CLI
    model = EgoNet(cfgs, pre_trained=cfgs.get("pre_trained", True),
                   dtype=cfg_mod.config_dtype(cfgs),
                   device=None if data_mesh else cfgs.get("device"),
                   mesh=data_mesh)
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
