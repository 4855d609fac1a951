"""Convert torchvision pretrained image-model checkpoints → msgpack params,
with neither flax nor JAX: the PyTorch port's command line for
``tools/convert_torchvision.py``, writing the same bytes.

Usage:
    python tools/torch_convert_torchvision.py --name resnet --weights resnet101.pth
    python tools/torch_convert_torchvision.py --all --weights-dir /path/to/pths

With torchvision importable and weights cached, ``--download`` builds the
state_dicts directly (timm for ``vit``). Without them, obtain the .pth files
where the reference runs (torchvision model URLs), copy them here, convert
once. The files go to ``--out``, else ``$I2V_TPU_CKPTS``, else
``./checkpoints``, as ``{name}.msgpack``: what
``i2v_tpu_torch.models.get_image_models`` loads.

Names: resnet (=resnet101), resnet50, vgg (=vgg16), alexnet,
squeezenet (=squeezenet1_1), densenet (=densenet161), vit (timm
vit_base_patch16_224).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from i2v_tpu_torch.models.convert import IMAGE_CONVERTERS, convert_torchvision  # noqa: E402

TORCHVISION_BUILDERS = {
    "resnet": "resnet101",
    "resnet50": "resnet50",
    "vgg": "vgg16",
    "alexnet": "alexnet",
    "squeezenet": "squeezenet1_1",
    "densenet": "densenet161",
    # 'vit' is a timm model: --download uses timm where importable, else
    # it needs --weights
}


def load_state_dict(name: str, weights: str | None, download: bool):
    import torch

    if weights:
        sd = torch.load(weights, map_location="cpu", weights_only=True)
        return sd.get("state_dict", sd) if isinstance(sd, dict) else sd
    if download:
        if name == "vit":  # timm model (TPAMI_attack.py:88-98)
            import timm

            return timm.create_model("vit_base_patch16_224",
                                     pretrained=True).state_dict()
        import torchvision.models as tvm

        model = getattr(tvm, TORCHVISION_BUILDERS[name])(pretrained=True)
        return model.state_dict()
    raise SystemExit("provide --weights <pth> or --download")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--name", choices=sorted(IMAGE_CONVERTERS))
    p.add_argument("--weights", help=".pth state_dict path")
    p.add_argument("--weights-dir", help="directory of {name}.pth files")
    p.add_argument("--all", action="store_true")
    p.add_argument("--download", action="store_true")
    p.add_argument("--out", default=None, help="checkpoint output dir")
    args = p.parse_args(argv)
    if not args.all and not args.name:
        p.error("--name or --all is required")

    names = sorted(IMAGE_CONVERTERS) if args.all else [args.name]
    for name in names:
        weights = args.weights
        if args.weights_dir:
            weights = os.path.join(args.weights_dir, f"{name}.pth")
        sd = load_state_dict(name, weights, args.download)
        path = convert_torchvision(name, sd, args.out)
        print(f"{name}: wrote {path}")


if __name__ == "__main__":
    main()
