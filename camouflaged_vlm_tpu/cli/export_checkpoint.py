"""Export a natively-trained cascade checkpoint to the reference's torch layout.

Inverse of the import converters (`io/convert.py`): loads an orbax train
checkpoint (`<save-dir>/ckpt_best` / `ckpt_last` from `cli/train.py`, whose
tree carries the TrainState's `params`) and writes a `.pth` state dict in the
layout the reference's own tooling saves/loads
(`/root/reference/train_ovcos_maskdecoder_edge.py` `torch.save(model.state_dict())`
/ `/root/reference/test_ovcos_maskdecoder_edge.py` `load_state_dict`), so a
model trained here can be evaluated or demoed with the reference's
CUDA stack — checkpoint interop in BOTH directions.

    python -m camouflaged_vlm_tpu.cli.export_checkpoint \
        --checkpoint runs/ckpt_best --out model_best.pth [--tiny | --config c.yaml]
"""

from __future__ import annotations

import argparse


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", required=True,
                   help="orbax checkpoint dir (cli/train.py ckpt_best/ckpt_last)")
    p.add_argument("--out", required=True, help="output .pth path")
    p.add_argument("--config", default=None, help="model config yaml (configs/*.yaml)")
    p.add_argument("--tiny", action="store_true", help="tiny config (smoke runs)")
    p.add_argument("--strict", action="store_true",
                   help="fail if any mapped param is missing from the checkpoint")
    args = p.parse_args()
    from ..utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    import numpy as np
    import torch

    from ..factory import build_full_cascade, build_tiny_cascade
    from ..io.checkpoint import restore_train_params_host
    from ..io.convert import export_cascade_checkpoint

    if args.config:
        from ..config import cascade_config_from_yaml

        cfg, _ = cascade_config_from_yaml(args.config)
    else:
        _, cfg = (build_tiny_cascade() if args.tiny else build_full_cascade())

    params = restore_train_params_host(args.checkpoint)
    sd, missing = export_cascade_checkpoint(params, cfg, strict=args.strict)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, args.out)
    print(f"wrote {args.out}: {len(sd)} tensors"
          + (f" ({len(missing)} mapped params absent: {missing[:3]}...)" if missing else ""))


if __name__ == "__main__":
    main()
