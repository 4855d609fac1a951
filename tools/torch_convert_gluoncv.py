"""Convert gluoncv video-model checkpoints → msgpack params for the six
reference models (utils.py:8-15), with BN folded into convs, with neither
flax nor JAX: the PyTorch port's command line for
``tools/convert_gluoncv.py``, writing the same bytes.

Usage:
    python tools/torch_convert_gluoncv.py --name i3d_resnet50 --weights i3d.pth [--report]
    python tools/torch_convert_gluoncv.py --name ... --weights ucf_ckpt.pth --ucf101
    python tools/torch_convert_gluoncv.py --name ... --weights i3d.pth --verify

Top-level gluoncv torch naming is confirmed by the reference's own attribute
accesses (i3d: ``res_layers.{i}``, base_attacks.py:739; slowfast:
``slow_res2/fast_res2``, base_attacks.py:741; tpn: ``layer1..4``,
base_attacks.py:743). Inner block naming follows the mmaction-style
conv{k}/bn{k}/downsample convention; ``--report`` prints the checkpoint's
keys so that a mismatch against a real checkpoint shows at once (the
conversion aborts if a conv the model needs has no source). ``--verify``
forwards a fixed clip through the port's model with the converted weights
on ``--device`` (a card unless ``--device cpu``); the conversion itself
runs on the host.
"""

import argparse
import os
import re
import sys
import warnings

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from i2v_tpu_torch.models import convert as cv  # noqa: E402


def _conv3d(sd, conv, bn=None, expect_bn=True):
    if conv is None:
        raise KeyError(
            "no conv weight found among the naming candidates — run with "
            "--report to see the checkpoint's actual keys")
    w = cv._np(sd[f"{conv}.weight"])
    b = cv._np(sd[f"{conv}.bias"]) if f"{conv}.bias" in sd else None
    folded = False
    if bn is not None and f"{bn}.weight" in sd:
        w, b = cv.fold_bn(w, b, sd, bn)
        folded = True
    if expect_bn and not folded:
        # a skipped fold would save conv weights that are numerically wrong
        # (the modules take BN as folded): say so
        warnings.warn(
            f"no BatchNorm folded into {conv!r} (bn candidate "
            f"{bn!r} not in the checkpoint) — if the source layer has a BN "
            "under an unrecognized name the converted weights are wrong; "
            "check --report / run --verify")
    kernel = cv.conv3d_kernel(w)
    if b is None:
        b = np.zeros(kernel.shape[-1], np.float32)
    return {"kernel": kernel.astype(np.float32), "bias": b.astype(np.float32)}


def _maybe(sd, *candidates):
    """The first key prefix among ``candidates`` with a weight in ``sd``
    (tolerance for naming drift)."""
    for c in candidates:
        if f"{c}.weight" in sd:
            return c
    return None


def _bottleneck(sd, base):
    entry = {}
    for k in (1, 2, 3):
        conv = _maybe(sd, f"{base}.conv{k}.conv", f"{base}.conv{k}")
        bn = _maybe(sd, f"{base}.conv{k}.bn", f"{base}.bn{k}")
        entry[f"conv{k}"] = _conv3d(sd, conv, bn)
    ds = _maybe(sd, f"{base}.downsample.conv", f"{base}.downsample.0")
    if ds:
        dsbn = _maybe(sd, f"{base}.downsample.bn", f"{base}.downsample.1")
        entry["downsample"] = _conv3d(sd, ds, dsbn)
    return entry


def convert_i3d(sd, stage_sizes):
    p = {}
    stem = _maybe(sd, "first_stage.0", "conv1.conv", "conv1")
    stem_bn = _maybe(sd, "first_stage.1", "conv1.bn", "bn1")
    p["conv1"] = _conv3d(sd, stem, stem_bn)
    for stage in range(4):
        for block in range(stage_sizes[stage]):
            base = f"res_layers.{stage}.{block}"
            p[f"layer{stage + 1}_{block}"] = _bottleneck(sd, base)
            # non-local blocks, where present (mmaction-lineage namings:
            # theta/phi/g 1x1x1 convs; out = conv_out.{conv,bn} | W.{0,1})
            nl = _maybe(sd, f"{base}.nonlocal_block.theta",
                        f"{base}.non_local.theta",
                        f"{base}.nonlocal_block.theta.conv")
            if nl:
                root = nl.rsplit(".theta", 1)[0]

                def _nl_conv(leaf):
                    # theta/phi/g are raw convs in the non-local design
                    return _conv3d(sd, _maybe(sd, f"{root}.{leaf}",
                                              f"{root}.{leaf}.conv"),
                                   expect_bn=False)

                p[f"layer{stage + 1}_{block}_nl"] = {
                    "theta": _nl_conv("theta"),
                    "phi": _nl_conv("phi"),
                    "g": _nl_conv("g"),
                    "out": _conv3d(
                        sd,
                        _maybe(sd, f"{root}.conv_out.conv", f"{root}.W.0",
                               f"{root}.conv_out"),
                        _maybe(sd, f"{root}.conv_out.bn", f"{root}.W.1",
                               f"{root}.bn")),
                }
    p["fc"] = cv._dense_entry(sd, _maybe(sd, "fc", "head.fc", "cls_head.fc_cls"))
    return p


def convert_slowfast(sd, stage_sizes):
    p = {}
    for pw in ("slow", "fast"):
        p[f"{pw}_conv1"] = _conv3d(sd, f"{pw}_conv1", f"{pw}_bn1")
        for stage in range(4):
            for block in range(stage_sizes[stage]):
                p[f"{pw}_res{stage + 2}_{block}"] = _bottleneck(
                    sd, f"{pw}_res{stage + 2}.{block}")
    for lat in ("p1", "res2", "res3", "res4"):
        src = _maybe(sd, f"lateral_{lat}.conv", f"lateral_{lat}.0",
                     f"lateral_{lat}")
        # gluoncv laterals are bare convs (BN-free by design)
        p[f"lateral_{lat}"] = _conv3d(
            sd, src, _maybe(sd, f"lateral_{lat}.bn", f"lateral_{lat}.1"),
            expect_bn=False)
    p["fc"] = cv._dense_entry(sd, _maybe(sd, "fc", "head.fc", "dp.fc"))
    return p


def convert_tpn(sd, stage_sizes):
    p = {"conv1": _conv3d(sd, _maybe(sd, "conv1.conv", "conv1"),
                          _maybe(sd, "conv1.bn", "bn1"))}
    for stage in range(4):
        for block in range(stage_sizes[stage]):
            p[f"layer{stage + 1}_{block}"] = _bottleneck(sd, f"layer{stage + 1}.{block}")

    # the neck: the TPN repository's module graph (SpatialModulation,
    # TemporalModulation ×2, Downampling, LevelFusion ×2, pyramid_fusion_op)
    # under the common top-level prefixes; an op that matches no candidate
    # is left out of the tree, and the model keeps its init there (the
    # loaders overlay the file and name what it left; --report shows the
    # checkpoint's naming)
    def neck(suffix):
        return tuple(f"{pre}.{suffix}" for pre in ("necks", "neck", "necks.0"))

    neck_map = {
        # ours: (conv-prefix candidates, bn suffix relative to the op root)
        "sm_0_0": (neck("spatial_modulation.spatial_modulation.0.0.conv"), ".bn"),
        "tm_0": (neck("temporal_modulation_ops.0.conv"), None),
        "tm_1": (neck("temporal_modulation_ops.1.conv"), None),
        "down_0": (neck("downsampling_ops.0.conv"), None),
        "lf1_op0": (neck("level_fusion_op.ops.0.conv"), ".norm"),
        "lf1_op1": (neck("level_fusion_op.ops.1.conv"), ".norm"),
        "lf1_fusion": (neck("level_fusion_op.fusion_conv.0"), ".1"),
        "lf2_op0": (neck("level_fusion_op2.ops.0.conv"), ".norm"),
        "lf2_op1": (neck("level_fusion_op2.ops.1.conv"), ".norm"),
        "lf2_fusion": (neck("level_fusion_op2.fusion_conv.0"), ".1"),
        "pyramid": (neck("pyramid_fusion_op.0"), ".1"),
    }
    for ours, (candidates, bn_suffix) in neck_map.items():
        src = _maybe(sd, *candidates)
        if src:
            bn = None
            if bn_suffix is not None:
                root = src.rsplit(".", 1)[0]
                bn = _maybe(sd, root + bn_suffix)
            # bn_suffix None marks the ops that are BN-free in the TPN
            # design (temporal modulation, downsampling: bare convs)
            p[ours] = _conv3d(sd, src, bn, expect_bn=bn_suffix is not None)
    fc = _maybe(sd, "fc", "cls_head.fc", "head.fc", "cls_head.fc_cls",
                "cls_head.fc1")
    if fc:
        p["fc"] = cv._dense_entry(sd, fc)
    return p


STAGES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
FAMILIES = {"i3d": convert_i3d, "slowfast": convert_slowfast, "tpn": convert_tpn}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--name", required=True,
                   help="e.g. i3d_resnet50, slowfast_resnet101, tpn_resnet50")
    p.add_argument("--weights", required=True)
    p.add_argument("--ucf101", action="store_true")
    p.add_argument("--report", action="store_true",
                   help="print source keys and exit (naming discovery)")
    p.add_argument("--verify", action="store_true",
                   help="after converting, forward a random clip through the "
                        "port's model (finite-logits check); with --gluoncv-cfg "
                        "also forward the gluoncv torch model and report the "
                        "max logit difference (checkpoint-level parity)")
    p.add_argument("--gluoncv-cfg", default=None,
                   help="gluoncv yaml config for --verify logit comparison "
                        "(requires gluoncv importable)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the --verify forward (cuda, cuda:N or cpu); "
                        "the conversion runs on the host")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    sd = torch.load(args.weights, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {re.sub(r"^module\.", "", k): v for k, v in sd.items()}
    if args.report:
        for k, v in sd.items():
            print(k, tuple(v.shape))
        return

    device = None
    if args.verify:
        from i2v_tpu_torch.cli.common import resolve_device

        device = resolve_device(args)  # before the conversion: no card, no work
    family, depth = args.name.split("_")
    params = FAMILIES[family](sd, STAGES[depth])
    suffix = "_ucf101" if args.ucf101 else ""
    path = cv.save_params(params, f"{args.name}{suffix}", args.out)
    print(f"wrote {path}")
    if args.verify:
        _verify(args.name, params, sd, ucf=args.ucf101,
                gluoncv_cfg=args.gluoncv_cfg, device=device)


def _verify(name, params, sd, *, ucf=False, gluoncv_cfg=None, device="cpu"):
    """Forward a fixed random clip through the port's model with the
    converted weights, laid over its init as ``get_video_model`` lays a
    file; with a gluoncv config (and gluoncv importable), also through the
    gluoncv torch model, and report the max logit difference."""
    import torch

    from i2v_tpu_torch.models.convert import from_jax_params, missing_modules
    from i2v_tpu_torch.models.registry import random_init_
    from i2v_tpu_torch.models.video_zoo import VIDEO_BUILDERS

    module = VIDEO_BUILDERS[name](num_classes=101 if ucf else 400)
    x01 = np.random.RandomState(0).rand(1, 3, 32, 224, 224).astype(np.float32)
    # the converters leave a tree partial on naming drift (e.g. the TPN
    # neck): overlay it on the init, as get_video_model does, so that the
    # checkpoints this tool diagnoses still run
    random_init_(module, torch.Generator().manual_seed(0))
    from_jax_params(module, params, mode="overlay")
    missing = missing_modules(module, params)
    if missing:
        print(f"WARNING: {len(missing)} module(s) at random init "
              f"(unconverted): {sorted(missing)[:8]}"
              f"{'…' if len(missing) > 8 else ''}")
    module = module.to(device).eval().requires_grad_(False)
    with torch.no_grad():
        logits, _ = module(torch.from_numpy(x01).to(device))
    logits = logits.float().cpu().numpy()
    assert np.isfinite(logits).all(), "converted model produced non-finite logits"
    print(f"torch logits: finite, top-5 {np.argsort(logits[0])[-5:][::-1]}")

    if gluoncv_cfg is None:
        print("(pass --gluoncv-cfg for a gluoncv-side logit comparison)")
        return
    from gluoncv.torch.engine.config import get_cfg_defaults
    from gluoncv.torch.model_zoo import get_model

    cfg = get_cfg_defaults()
    cfg.merge_from_file(gluoncv_cfg)
    tm = get_model(cfg).eval()
    tm.load_state_dict(sd, strict=False)
    mean = torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1, 1)
    with torch.no_grad():
        want = tm((torch.from_numpy(x01) - mean) / std).numpy()
    diff = np.abs(logits - want).max()
    print(f"max |port - gluoncv| logit diff: {diff:.2e} "
          f"({'OK' if diff < 1e-3 else 'MISMATCH — check --report naming'})")


if __name__ == "__main__":
    main()
