#!/usr/bin/env python3
"""Convert a checkpoint of the JAX package (orbax) into the PyTorch port's.

    python3 convert_jax_checkpoint.py saved_models/run/min_val_loss out_dir

restores the orbax checkpoint directory without a template, takes its
model parameters, and writes `out_dir/<name>/state.pt` (name: the source
directory's, or `--name`) in the port's format, with the source's
`<name>.meta.json` sidecar copied beside it. `python -m
neural_lam_tpu_torch.predict --load out_dir/<name>` then forecasts from it.

Run it where JAX and orbax are installed; it imports them and the port,
and nothing of the JAX package. The AdamW state is not carried across: a
converted checkpoint holds the model's weights alone, so the port's
trainer restores it with `--load` but refuses `--restore_opt`.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def convert(jax_ckpt, out_dir, name=None) -> Path:
    """Write the port's checkpoint of orbax checkpoint `jax_ckpt`; returns
    its directory."""
    import jax
    import orbax.checkpoint as ocp

    from neural_lam_tpu_torch.checkpoint import save_checkpoint
    from neural_lam_tpu_torch.convert import params_from_jax

    src = Path(jax_ckpt).absolute()
    with ocp.PyTreeCheckpointer() as ckptr:
        restored = ckptr.restore(src)
    # without a template, orbax may give lists back as dicts keyed "0",
    # "1", ...; params_from_jax flattens both to the same dotted keys
    params = jax.tree_util.tree_map(np.asarray, restored["params"])
    meta_path = Path(str(src) + ".meta.json")
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    name = name or src.name
    save_checkpoint(out_dir, name, params_from_jax(params),
                    meta=dict(meta, converted_from=str(src)))
    return Path(out_dir).absolute() / name


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("jax_ckpt", help="orbax checkpoint directory of the "
                                         "JAX package (e.g. run/last)")
    parser.add_argument("out_dir", help="directory to write the port's "
                                        "checkpoint into")
    parser.add_argument("--name", default=None,
                        help="checkpoint name (default: the source "
                             "directory's name)")
    args = parser.parse_args(argv)
    path = convert(args.jax_ckpt, args.out_dir, args.name)
    print(f"wrote {path} (model weights only; no optimizer state)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
