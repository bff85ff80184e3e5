"""Precision-drift harness: the angle drift between two compute dtypes, and
the harness's outputs for holding the port against the JAX package's.
Port of ``egonet_tpu/precision.py``.

Runs the whole device program (separable warp -> HRNet-W48 -> inverse
affine -> FC lifter -> rigid solve -> alpha, ``EgoNet._core``) on one
384x1280 frame and n boxes drawn from ``np.random.RandomState(seed)``
exactly as the JAX harness draws them, with the weights ``rng_seed=seed``
gives both packages.  The lifter statistics decode the random network's
outputs into near-canonical cuboids (what a trained ``LS.npy`` does), so
the rigid fit is well conditioned while HRNet's drift still reaches the
angles through the lifter input.

``tests/data/torch_w48_fixture.npz`` holds the JAX package's fp32 outputs
of this harness at full width (seeds 0 and 1, 6 instances each);
``tests/test_torch_precision.py`` and ``chip_smoke.py`` hold the port
against it with :func:`fixture_gaps`.  With random weights most of the
coordinate head's sigmoids saturate, so the screen keypoints rest on a few
ill-conditioned coordinates and the angles on the lifter statistics; the
head's logits and the heatmaps' RMS are the trunk's well-conditioned
outputs, held at a relative tolerance.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from egonet_tpu_torch.data import cuboid as cb
from egonet_tpu_torch.ops import affine

# euler angles are (rx, ry, rz); ry is the KITTI rotation
RY = 1


def _plausible_ls_stats() -> dict:
    """Lifter normalization stats that decode random-ish network outputs
    into near-canonical cuboids (geometry of a trained L.pth/LS.npy)."""
    box = cb.construct_box_3d(3.9, 1.5, 1.7, interpolate=True)   # [3, 33]
    rel = box[:, 1:] - box[:, :1]                                # center-rel
    rot = cb.rot_y_matrix(0.9)
    mean_out = (rot @ rel).T.reshape(1, -1).astype(np.float32)   # [1, 96]
    return {
        "mean_in": np.tile([600.0, 180.0], 33)[None].astype(np.float32),
        "std_in": np.full((1, 66), 150.0, np.float32),
        "mean_out": mean_out,
        "std_out": np.full((1, 96), 0.05, np.float32),
    }


def harness_inputs(n_instances: int = 6, seed: int = 0):
    """(images [1, 384, 1280, 3] uint8, boxes [n, 4]) in the JAX harness's
    draw order."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, size=(1, 384, 1280, 3), dtype=np.uint8)
    x = rng.uniform(50, 900, n_instances)
    y = rng.uniform(30, 180, n_instances)
    boxes = np.stack([x, y, x + rng.uniform(80, 280, n_instances),
                      y + rng.uniform(50, 140, n_instances)], axis=1)
    return images, boxes


def harness_model(dtype, seed: int = 0, device=None, cfgs=None):
    """``EgoNet`` with the harness's weights (``rng_seed=seed``) and lifter
    statistics; ``cfgs`` defaults to the shipped W48 demo config."""
    from egonet_tpu_torch.config import demo_config
    from egonet_tpu_torch.models.egonet import EgoNet
    model = EgoNet(cfgs or demo_config(), dtype=dtype, rng_seed=seed,
                   device=device)
    model.load_state(ls_stats=_plausible_ls_stats())
    return model


class _HeadLogits(TorchFunctionMode):
    """Keeps the input of the last ``torch.sigmoid`` call: in ``_core``
    the coordinate head's logits (HRNet's one sigmoid)."""

    logits = None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.sigmoid:
            self.logits = args[0]
        return func(*args, **(kwargs or {}))


def harness_outputs(model, n_instances: int = 6, seed: int = 0) -> dict:
    """``model._core`` on the harness inputs -> {'kpts': [n, K, 2] screen
    px, 'lifter': [n, out] un-normalized lifter output, 'euler': [n, 3],
    'alpha': [n], 'logits': [n, 2K] the coordinate head's pre-sigmoid
    output, 'maps_rms': [n, K] each heatmap's RMS}, float64 numpy."""
    from egonet_tpu_torch.models.egonet import pack_meta
    images, boxes = harness_inputs(n_instances, seed)
    width, height = model.resolution
    mats = affine.crop_matrices_for_boxes(boxes, (height, width),
                                          height / width, 1.1)
    meta = pack_meta(mats["inv"], np.zeros(n_instances),
                     np.ones(n_instances), 707.0, 604.0,
                     (images.shape[2], images.shape[1]))
    maps = []
    hook = model.hrnet.register_forward_hook(
        lambda _m, _i, out: maps.append(out[0]))
    try:
        with torch.inference_mode(), _HeadLogits() as head:
            flat = model._core(model._upload(images), model._upload(meta),
                               np.zeros(n_instances, np.int64),
                               alpha_mode="proj")
    finally:
        hook.remove()

    def host(t):
        return t.double().cpu().numpy()

    flat = host(flat.float())
    k2 = int(model.cfgs["heatmapModel"]["num_joints"]) * 2
    od = int(model.cfgs["FCModel"]["output_size"])
    return {"kpts": flat[:, :k2].reshape(n_instances, -1, 2),
            "lifter": flat[:, k2:k2 + od],
            "euler": flat[:, k2 + od:k2 + od + 3],
            "alpha": flat[:, -2],
            "logits": host(head.logits).reshape(n_instances, k2),
            "maps_rms": np.sqrt((host(maps[0]) ** 2).mean(axis=(2, 3)))}


def _angdiff_deg(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.degrees(np.minimum(d, 2 * np.pi - d))


def drift_harness(dtype_a, dtype_b, n_instances: int = 6, seed: int = 0,
                  device=None, cfgs=None) -> dict:
    """Run the device program in two dtypes on identical inputs; return
    drift statistics (degrees)."""
    outs = [harness_outputs(harness_model(dt, seed, device, cfgs),
                            n_instances, seed) for dt in (dtype_a, dtype_b)]
    dry = _angdiff_deg(outs[0]["euler"][:, RY], outs[1]["euler"][:, RY])
    dal = _angdiff_deg(outs[0]["alpha"], outs[1]["alpha"])
    return {
        "median_dry_deg": float(np.median(dry)),
        "median_dalpha_deg": float(np.median(dal)),
        "max_dry_deg": float(dry.max()),
        "max_dalpha_deg": float(dal.max()),
        "n": n_instances,
    }


def _rel_gap(out, ref):
    """max over instances of |out - ref| / |ref| (L2 over the last axis)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float((np.linalg.norm(out - ref, axis=-1)
                  / np.linalg.norm(ref, axis=-1)).max())


def fixture_gaps(out: dict, ref: dict) -> dict:
    """Gaps between harness outputs and a reference's (same keys): |d kpts|
    per coordinate in px, |d ry| and |d alpha| in degrees, max and median;
    where both hold them, the relative gaps of the head's logits and of the
    heatmaps' RMS, max over instances."""
    dk = np.abs(np.asarray(out["kpts"]) - np.asarray(ref["kpts"]))
    dry = _angdiff_deg(np.asarray(out["euler"])[..., RY],
                       np.asarray(ref["euler"])[..., RY])
    dal = _angdiff_deg(out["alpha"], ref["alpha"])
    gaps = {"max_d_kpts_px": float(dk.max()),
            "median_d_kpts_px": float(np.median(dk)),
            "max_d_ry_deg": float(dry.max()),
            "median_d_ry_deg": float(np.median(dry)),
            "max_d_alpha_deg": float(dal.max()),
            "median_d_alpha_deg": float(np.median(dal))}
    for key in ("logits", "maps_rms"):
        if key in out and key in ref:
            gaps[f"max_rel_d_{key}"] = _rel_gap(out[key], ref[key])
    return gaps


# ---------------------------------------------------------------------------
# The IGR train step at full width, held against the JAX package's
# (tests/data/torch_train_fixture.npz, tests/test_torch_train_fixture.py,
# chip_smoke.py's train_igrs phase)

# the top-level stages whose gradient norm the fixture records
TRAIN_STAGES = ("conv1", "bn1", "conv2", "bn2", "layer1", "transition1",
                "stage2", "transition2", "stage3", "transition3", "stage4",
                "head1", "head2")
# batch-norm layers whose updated running statistics it records
TRAIN_BN = ("bn1", "layer1.3.bn3", "stage2.0.branches.1.3.bn2",
            "stage3.3.branches.2.3.bn2", "stage4.2.branches.3.3.bn2",
            "head2.3.bn2")


def train_fixture_batch(cfgs: dict, n_instances: int = 2, seed: int = 0):
    """A host IGR batch: the harness's frame and boxes
    (:func:`harness_inputs`), each box's patch->source affine (aspect
    fixed as the loader does) and random crop-frame joints, all slots
    real."""
    images, boxes = harness_inputs(n_instances, seed)
    w, h = cfgs["heatmapModel"]["input_size"]
    inv = []
    for b in boxes:
        ret = affine.resize_bbox(*b, target_ar=h / w)
        inv.append(affine.get_affine_transform(ret["c"], ret["s"], 0.0,
                                               (h, w), inv=True))
    rng = np.random.RandomState(seed + 100)
    joints = np.concatenate(
        [rng.uniform(8, min(w, h) - 8, (n_instances, 33, 2)),
         np.ones((n_instances, 33, 1))], axis=2)
    return {"images": images,
            "inv_mats": np.asarray(inv, np.float32),
            "img_idx": np.zeros(n_instances, np.int32),
            "joints": joints.astype(np.float32),
            "mask": np.ones(n_instances, np.float32),
            "sup_mask": np.ones(n_instances, np.float32),
            "img_wh": np.tile(np.array([[1280.0, 384.0]], np.float32),
                              (n_instances, 1))}


def train_step_outputs(trainer, state, batch) -> dict:
    """One forward / backward of ``trainer`` (cross-ratio off) on a host
    batch, without the optimizer step: the loss and its components, the
    gradient norm of each of :data:`TRAIN_STAGES` and the updated running
    statistics of :data:`TRAIN_BN`, float64 numpy."""
    model = state.model
    model.train()
    model.zero_grad(set_to_none=True)
    total, comps = trainer.loss_fn(model, trainer._device_batch(batch),
                                   False)
    total.backward()
    sq = dict.fromkeys(TRAIN_STAGES, 0.0)
    for name, p in model.named_parameters():
        if p.grad is not None:
            sq[name.split(".")[0]] += float(p.grad.double().square().sum())
    out = {"loss": float(total.detach()),
           **{k: float(v.detach()) for k, v in comps.items()},
           "grad_norms": np.sqrt([sq[s] for s in TRAIN_STAGES])}
    for name in TRAIN_BN:
        bn = model.get_submodule(name)
        for stat in ("running_mean", "running_var"):
            out[f"{name}.{stat}"] = getattr(bn, stat).double().cpu().numpy()
    return out


def train_gaps(out: dict, ref: dict) -> dict:
    """Relative gaps of :func:`train_step_outputs` ``out`` against ``ref``:
    the loss and each component, the largest over the stages' gradient
    norms, and the largest over the BN layers of the running statistics'
    largest gap relative to their largest entry."""
    gaps = {k: abs(out[k] - ref[k]) / abs(ref[k])
            for k in ("loss", "hm", "coor")}
    gaps["grad_norms"] = float(np.max(
        np.abs(out["grad_norms"] - ref["grad_norms"]) / ref["grad_norms"]))
    gaps["bn_stats"] = max(
        float(np.abs(out[k] - ref[k]).max() / np.abs(ref[k]).max())
        for k in ref if k.endswith(("running_mean", "running_var")))
    return gaps
