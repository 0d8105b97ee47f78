"""Checkpoint converter of the port: ``bdt-convert``, ``.npz`` <-> the reference's Keras ``.h5``.

    python -m building_detection_tpu_torch.cli.convert res34 resnet34.h5 res34.npz
    python -m building_detection_tpu_torch.cli.convert res34 epoch_30_weights.npz res34.h5

The counterpart of ``building_detection_tpu/cli/convert.py``, with the same
flags.  The direction follows from the extensions: ``.h5``/``.hdf5`` in
imports strictly into a ``.npz`` (params and BN state, metadata ``model``);
``.npz`` in is checked against the named model and exported in tf_keras's
positional layer order (:func:`models.registry.keras_layer_order`).  The
model is built on the CPU only as a template of names, shapes and dtypes;
no device is used.  Either package reads the files the other writes.
"""
from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bdt-convert",
        description="Convert model weights between .npz checkpoints and reference-format Keras .h5 "
        "(direction from extensions; PyTorch port).",
    )
    p.add_argument("model", choices=["res34", "hrnet", "v3plus", "scse", "bam"])
    p.add_argument("src", help="source weights (.h5/.hdf5 or .npz)")
    p.add_argument("dst", help="destination (.npz or .h5/.hdf5)")
    p.add_argument(
        "--image-size", type=int, default=512,
        help="accepted as in the JAX CLI; the port's weight shapes do not depend on it",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    h5_exts = (".h5", ".hdf5")
    src_h5 = args.src.endswith(h5_exts)
    if src_h5 == args.dst.endswith(h5_exts):
        raise SystemExit(f"exactly one of src/dst must be .h5 (got {args.src!r} -> {args.dst!r})")

    import torch

    from building_detection_tpu_torch.core.module import jax_variables
    from building_detection_tpu_torch.models.registry import init_model, keras_layer_order
    from building_detection_tpu_torch.train import checkpoint as ckpt

    params, state = jax_variables(init_model(args.model, torch.Generator().manual_seed(0)))
    if src_h5:
        params, state, report = ckpt.import_h5_weights(args.src, params, state, strict=True)
        print(f"[convert] {args.model}: {report.summary()}")
        ckpt.save_variables(args.dst, params, state, metadata={"model": args.model})
    else:
        loaded_params, loaded_state, *_ = ckpt.load_variables(args.src)
        # a wrong-model npz fails here instead of producing an unloadable .h5
        try:
            ckpt.check_matches_model(args.src, loaded_params, loaded_state, params, state, args.model)
        except ValueError as e:
            raise SystemExit(str(e))
        ckpt.export_h5_weights(args.dst, loaded_params, loaded_state, layer_order=keras_layer_order(args.model))
    print(f"[convert] wrote {args.dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
