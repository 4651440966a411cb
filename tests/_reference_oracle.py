"""Import scaffolding that loads the REFERENCE's own torch modules as test
oracles.

The reference (`/root/reference`) cannot be imported wholesale: its package
`models/__init__.py` pulls mmseg (hard mmcv assert) and open_clip, and
`cocotrainers/mapleAlphaCLIP.py` imports dassl/tensorboardX — none installed.
This module builds surgical import paths:

  * `load_refsam()` — synthetic package over
    `/root/reference/models/mmseg/models/sam/` (common, image_encoder,
    mask_decoder_edge, transformer_maskdecoder_edge). Only torch needed.
  * `load_ref_clip_model()` — `/root/reference/alpha_clip_rw/model.py` with a
    `loralib` stub (lora is gated off; import-only).
  * `load_ref_maple()` — `/root/reference/cocotrainers/mapleAlphaCLIP.py`
    with dassl / utils (reference's log) stubs; gives the real
    MultiModalPromptLearner / TextEncoder / CustomCLIP.
  * `load_ref_cascade_module()` — `/root/reference/models/sam_maskdecoder_edge.py`
    with registry/loss/mmseg-redirect stubs and torch.load patched to hand
    back caller-supplied text-feature banks; gives the real registered SAM
    class whose `infer_test` is the round-trip oracle.

NOTE: reference code is treated strictly as DATA here (loaded modules under
test-local names); nothing is copied into the repo.
"""

from __future__ import annotations

import importlib
import importlib.util
import sys
import types

REF = "/root/reference"


def _stub_module(name: str, **attrs) -> types.ModuleType:
    mod = sys.modules.get(name)
    if mod is None:
        mod = types.ModuleType(name)
        sys.modules[name] = mod
    for k, v in attrs.items():
        setattr(mod, k, v)
    return mod


def _load_file(name: str, path: str, package: str | None = None) -> types.ModuleType:
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    if package is not None:
        mod.__package__ = package
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_refsam() -> types.ModuleType:
    """Synthetic package `refsam` -> the reference's SAM sub-modules."""
    if "refsam.image_encoder" in sys.modules:
        return sys.modules["refsam"]
    pkg = types.ModuleType("refsam")
    pkg.__path__ = [f"{REF}/models/mmseg/models/sam"]
    pkg.__package__ = "refsam"
    sys.modules["refsam"] = pkg
    for sub in ("common", "image_encoder", "mask_decoder_edge",
                "transformer_maskdecoder_edge"):
        mod = importlib.import_module(f"refsam.{sub}")
        setattr(pkg, sub, mod)
    return pkg


def _stub_dassl():
    import torch

    engine = _stub_module("dassl.engine", TrainerX=type("TrainerX", (object,), {}))
    utils = _stub_module(
        "dassl.utils",
        load_pretrained_weights=lambda *a, **k: None,
        load_checkpoint=lambda *a, **k: torch.load(a[0], map_location="cpu"),
    )
    optim = _stub_module(
        "dassl.optim",
        build_optimizer=lambda *a, **k: None,
        build_lr_scheduler=lambda *a, **k: None,
    )
    metrics = _stub_module("dassl.metrics", compute_accuracy=lambda *a, **k: None)
    _stub_module("dassl", engine=engine, utils=utils, optim=optim, metrics=metrics)


def load_ref_clip_model() -> types.ModuleType:
    """`alpha_clip_rw.model` (loralib stubbed; lora_adapt is always False)."""
    _stub_module("loralib")
    # alpha_clip_rw/alpha_clip.py deps absent from this image. Only the
    # tokenizer + model builder run in tests: the torchvision transforms are
    # never invoked, ftfy only canonicalises unicode (prompts are ASCII).
    import packaging
    import packaging.version  # ensure the submodule attribute exists

    _stub_module("pkg_resources", packaging=packaging)
    _stub_module("ftfy", fix_text=lambda s: s)
    class _T:  # placeholder transform symbols (never called)
        def __init__(self, *a, **k):
            pass
    tv_t = _stub_module(
        "torchvision.transforms",
        Compose=_T, Resize=_T, CenterCrop=_T, ToTensor=_T, Normalize=_T,
    )
    _stub_module("torchvision", transforms=tv_t)
    if REF not in sys.path:
        sys.path.append(REF)  # for `alpha_clip_rw` absolute imports
    return importlib.import_module("alpha_clip_rw.model")


def load_ref_maple() -> types.ModuleType:
    """`cocotrainers.mapleAlphaCLIP` with dassl + reference-utils stubs."""
    if "ref_mapleAlphaCLIP" in sys.modules:
        return sys.modules["ref_mapleAlphaCLIP"]
    load_ref_clip_model()
    _stub_dassl()
    # the reference's root `utils.py` pulls tensorboardX; only `log` is used
    _stub_module("utils", log=lambda *a, **k: None)
    return _load_file(
        "ref_mapleAlphaCLIP", f"{REF}/cocotrainers/mapleAlphaCLIP.py"
    )


class _MapleCfg:
    """Duck-typed stand-in for the dassl CfgNode consumed by
    MultiModalPromptLearner (`mapleAlphaCLIP.py:86-95`)."""

    def __init__(self, n_ctx=4, ctx_init="a photo of a", prompt_depth=9, imsize=336):
        self.TRAINER = types.SimpleNamespace(
            MAPLE=types.SimpleNamespace(
                N_CTX=n_ctx, CTX_INIT=ctx_init, PROMPT_DEPTH=prompt_depth
            )
        )
        self.INPUT = types.SimpleNamespace(SIZE=(imsize, imsize))


def maple_cfg(**kw) -> _MapleCfg:
    return _MapleCfg(**kw)


def load_ref_cascade_module(train_bank, test_bank) -> types.ModuleType:
    """The reference's registered SAM cascade (`models/sam_maskdecoder_edge.py`).

    `train_bank`/`test_bank`: torch tensors substituted for the repo's
    `{Train,Test}CamoPromptsTextFeaturesViTB-14-336.pth` (the ctor
    torch.loads them unconditionally, `sam_maskdecoder_edge.py:177-182`).
    """
    import torch

    if "refmodels.sam_maskdecoder_edge" in sys.modules:
        # Already loaded (another test file): registration ran once at exec
        # time and lives in the cached module's _registry — re-running the
        # stub dance would clobber it with a fresh empty dict. Only the
        # bank loader is per-call state (each caller brings its own banks).
        mod = sys.modules["refmodels.sam_maskdecoder_edge"]
        orig_load = torch.load

        def fake_load(path, *a, **k):
            if isinstance(path, str) and "TrainCamoPrompts" in path:
                return train_bank
            if isinstance(path, str) and "TestCamoPrompts" in path:
                return test_bank
            return orig_load(path, *a, **k)

        mod._bank_loader = fake_load
        return mod

    refsam = load_refsam()
    load_ref_maple()

    # absolute `from models import register` / `models.ovcamo_loss`
    registry = {}

    def register(name):
        def deco(cls):
            registry[name] = cls
            return cls
        return deco

    models_pkg = _stub_module("models", register=register)
    models_pkg.__path__ = [f"{REF}/models"]
    ovcamo_loss = _load_file("models.ovcamo_loss", f"{REF}/models/ovcamo_loss.py")
    models_pkg.ovcamo_loss = ovcamo_loss

    # pre-seed the relative imports of sam_maskdecoder_edge (loaded under the
    # synthetic package name `refmodels` so `.mmseg.models.sam` / `.iou_loss`
    # resolve without executing the real mmseg __init__ chain)
    pkg = _stub_module("refmodels")
    pkg.__path__ = [f"{REF}/models"]
    iou_loss = _load_file("refmodels.iou_loss", f"{REF}/models/iou_loss.py",
                          package="refmodels")
    mmseg = _stub_module("refmodels.mmseg")
    mmseg_models = _stub_module("refmodels.mmseg.models")
    sam_ns = _stub_module(
        "refmodels.mmseg.models.sam",
        ImageEncoderViT=refsam.image_encoder.ImageEncoderViT,
        MaskDecoder_Edge=refsam.mask_decoder_edge.MaskDecoder,
        TwoWayTransformer_MaskDecoder_Edge=refsam.transformer_maskdecoder_edge.TwoWayTransformer,
        # stock (unused at runtime) symbols the import list mentions
        MaskDecoder=refsam.mask_decoder_edge.MaskDecoder,
        TwoWayTransformer=refsam.transformer_maskdecoder_edge.TwoWayTransformer,
    )
    mmseg.models = mmseg_models
    mmseg_models.sam = sam_ns

    orig_load = torch.load

    def fake_load(path, *a, **k):
        if isinstance(path, str) and "TrainCamoPrompts" in path:
            return train_bank
        if isinstance(path, str) and "TestCamoPrompts" in path:
            return test_bank
        return orig_load(path, *a, **k)

    torch.load = fake_load
    try:
        mod = _load_file(
            "refmodels.sam_maskdecoder_edge",
            f"{REF}/models/sam_maskdecoder_edge.py",
            package="refmodels",
        )
    finally:
        torch.load = orig_load
    mod._bank_loader = fake_load  # re-patch hook for instantiating SAM later
    mod._registry = registry
    return mod


def load_ref_ovcos() -> types.ModuleType:
    """The reference's class-aware OVCOS metricer
    (`/root/reference/recorder/ovcos_metricer.py`) as an oracle.

    py_sod_metrics (pip) is unavailable in this image; its bases are provided
    by the reference's own self-contained `recorder/sod_metric.py`, which
    implements the same algorithms with the same helper signatures
    (`_prepare_data`/`_get_adaptive_threshold`/`cal_*`). The class-aware
    subclasses override __init__/step, so only the `cal_*` methods and the
    two utils are inherited — exactly what sod_metric.py supplies.
    """
    import numpy as np

    if "ref_ovcos_metricer" in sys.modules:
        return sys.modules["ref_ovcos_metricer"]
    sm = _load_file("ref_sod_metric", f"{REF}/recorder/sod_metric.py")
    sod_metrics = _stub_module(
        "py_sod_metrics.sod_metrics",
        MAE=sm.MAE, Emeasure=sm.Emeasure, Fmeasure=sm.Fmeasure,
        Smeasure=sm.Smeasure, WeightedFmeasure=sm.WeightedFmeasure,
    )
    utils = _stub_module(
        "py_sod_metrics.utils",
        TYPE=np.float64,
        get_adaptive_threshold=sm._get_adaptive_threshold,
        prepare_data=sm._prepare_data,
    )
    _stub_module("py_sod_metrics", sod_metrics=sod_metrics, utils=utils)
    return _load_file("ref_ovcos_metricer", f"{REF}/recorder/ovcos_metricer.py")


def load_ref_eval_module() -> types.ModuleType:
    """The reference's OWN eval entry (`test_ovcos_maskdecoder_edge.py`)
    as an oracle — gives the real `eval_psnr_ovcamo_both` (:68-148), i.e.
    the complete per-image host path: calc_cod on the model-res sigmoid,
    stage-2 alpha handoff + Classification.process, cv2 float resize to the
    original mask size, *255 truncation, OVCOSMetricer.step, and the final
    aggregation. Call AFTER load_ref_cascade_module (shares the `models`
    stub). Caller must neutralise `.cuda()` (torch here is CPU-only).
    """
    if "ref_eval_entry" in sys.modules:
        return sys.modules["ref_eval_entry"]

    # recorder package: real ovcos metricer + real self-contained sod
    # metrics + real Classification evaluator (sklearn), no vendored extras
    ovcos = load_ref_ovcos()
    sm = sys.modules["ref_sod_metric"]
    rec = _stub_module("recorder", OVCOSMetricer=ovcos.OVCOSMetricer)
    sys.modules["recorder.sod_metric"] = sm
    rec.sod_metric = sm

    # REAL root utils.py (calc_cod / Averager / set_log_path). It needs
    # `recorder.sod_metric` (above) + tensorboardX (installed). If the maple
    # loader already planted its {log} stub under "utils", load the real
    # file under the name and graft the missing symbols.
    if "utils" in sys.modules and not hasattr(sys.modules["utils"], "calc_cod"):
        real_utils = _load_file("ref_root_utils", f"{REF}/utils.py")
        for k in dir(real_utils):
            if not k.startswith("__") and not hasattr(sys.modules["utils"], k):
                setattr(sys.modules["utils"], k, getattr(real_utils, k))
    elif "utils" not in sys.modules:
        _load_file("utils", f"{REF}/utils.py")

    ne = _load_file("recorder.new_evaluator", f"{REF}/recorder/new_evaluator.py")
    rec.new_evaluator = ne

    # datasets package: only the class-name constants are touched at import
    cn = _load_file(
        "datasets.ovcamo_info.class_names",
        f"{REF}/datasets/ovcamo_info/class_names.py",
    )
    ovi = _stub_module("datasets.ovcamo_info", class_names=cn)
    _stub_module("datasets", ovcamo_info=ovi)

    _stub_module("models")  # `import models` (registry already live if the
    # cascade module was loaded first; the eval fn itself never uses it)
    mac = _stub_module("cocotrainers.mapleAlphaCLIP", TestMaPLeAlphaCLIP=object)
    _stub_module("cocotrainers", mapleAlphaCLIP=mac)

    return _load_file("ref_eval_entry", f"{REF}/test_ovcos_maskdecoder_edge.py")


def randomize_torch_module(module, std=0.05, seed=0):
    """In-place N(0, std) init of every param/buffer (fp32) so zero-init
    params (rel_pos_*, alpha conv) actually exercise their code paths."""
    import torch

    g = torch.Generator().manual_seed(seed)
    sd = module.state_dict()
    for k, v in sd.items():
        if v.dtype.is_floating_point:
            sd[k] = torch.randn(v.shape, generator=g, dtype=torch.float32) * std
    module.load_state_dict(sd)
    return module
