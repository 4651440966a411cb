"""Model-zoo checkpoint resolution: name -> cached, checksum-verified file.

Equivalent of the reference's downloader
(`/root/reference/alpha_clip_rw/alpha_clip.py:30-75,102-135`): a model-name
registry whose URLs embed the expected SHA256 as the second-to-last path
segment (OpenAI's public CLIP release layout), a cache directory keyed by
file name, integrity verification on every hit (a corrupted cache entry is
re-downloaded once, then errors), and a clear available-models error for
unknown names.

`resolve_checkpoint` is what the CLIs call: an existing file path passes
through untouched, a registry name or URL is downloaded-and-verified, so
`--clip-ckpt ViT-L/14@336px` works wherever egress exists and fails with an
actionable message where it doesn't (this dev environment is zero-egress —
the unit tests exercise the full logic against a localhost HTTP server).
"""

from __future__ import annotations

import hashlib
import os
import urllib.request
from typing import Dict, List, Optional

from ..utils.logging import log

# Public OpenAI CLIP release URLs (same registry the reference vendors —
# public constants). The cascade uses ViT-L/14@336px; the rest are listed
# for completeness with the reference's available_models().
CLIP_MODELS: Dict[str, str] = {
    "RN50": "https://openaipublic.azureedge.net/clip/models/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt",
    "RN101": "https://openaipublic.azureedge.net/clip/models/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt",
    "RN50x4": "https://openaipublic.azureedge.net/clip/models/7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd/RN50x4.pt",
    "RN50x16": "https://openaipublic.azureedge.net/clip/models/52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa/RN50x16.pt",
    "RN50x64": "https://openaipublic.azureedge.net/clip/models/be1cfb55d75a9666199fb2206c106743da0f6468c9d327f3e0d0a543a9919d9c/RN50x64.pt",
    "ViT-B/32": "https://openaipublic.azureedge.net/clip/models/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
    "ViT-B/16": "https://openaipublic.azureedge.net/clip/models/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
    "ViT-L/14": "https://openaipublic.azureedge.net/clip/models/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt",
    "ViT-L/14@336px": "https://openaipublic.azureedge.net/clip/models/3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02/ViT-L-14-336px.pt",
}

DEFAULT_CACHE = os.path.expanduser("~/.cache/camouflaged_vlm_tpu")


def available_models() -> List[str]:
    return list(CLIP_MODELS.keys())


def _sha256_of(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(
    url: str,
    root: str = DEFAULT_CACHE,
    expected_sha256: Optional[str] = None,
    progress: bool = True,
) -> str:
    """Fetch `url` into `root` with integrity verification; cached by file
    name. With no explicit checksum, the URL's second-to-last path segment
    is used when it looks like one (the OpenAI release layout); otherwise
    integrity checking is skipped."""
    os.makedirs(root, exist_ok=True)
    filename = os.path.basename(url)

    if expected_sha256 is None:
        seg = url.split("/")[-2] if "/" in url else ""
        if len(seg) == 64 and all(c in "0123456789abcdef" for c in seg.lower()):
            expected_sha256 = seg.lower()

    if expected_sha256 is None:
        # Unverifiable URL: namespace the cache entry by the URL itself so a
        # same-named file from a different host can never be returned in its
        # place (verified entries are safe to share a name — a mismatch
        # re-downloads).
        filename = hashlib.sha256(url.encode()).hexdigest()[:12] + "-" + filename
    target = os.path.join(root, filename)

    if os.path.exists(target) and not os.path.isfile(target):
        raise RuntimeError(f"{target} exists and is not a regular file")

    if os.path.isfile(target):
        if expected_sha256 is None or _sha256_of(target) == expected_sha256:
            return target
        log(f"[download] {target} exists but its SHA256 does not match; re-downloading")

    tmp = target + ".part"
    with urllib.request.urlopen(url) as source, open(tmp, "wb") as out:
        total = int(source.info().get("Content-Length") or 0)
        done = 0
        next_pct = 10
        while True:
            buf = source.read(1 << 16)
            if not buf:
                break
            out.write(buf)
            done += len(buf)
            if progress and total and done * 100 >= next_pct * total:
                log(f"[download] {filename}: {done * 100 // total}% of {total / 1e6:.1f} MB")
                next_pct += 10
    if expected_sha256 is not None and _sha256_of(tmp) != expected_sha256:
        os.remove(tmp)
        raise RuntimeError(
            f"{url} downloaded but the SHA256 checksum does not match {expected_sha256}"
        )
    os.replace(tmp, target)  # atomic: a crashed download never poisons the cache
    return target


def resolve_checkpoint(
    name_or_path: Optional[str],
    root: str = DEFAULT_CACHE,
    registry: Dict[str, str] = CLIP_MODELS,
) -> Optional[str]:
    """Existing file path -> itself; registry name or URL -> cached download.

    Mirrors the reference's `alpha_clip.load` name resolution
    (`alpha_clip_rw/alpha_clip.py:135-141`), with its exact unknown-name
    error shape (model not found; available models = ...).
    """
    if not name_or_path:
        return name_or_path
    if os.path.isfile(name_or_path):
        return name_or_path
    if name_or_path in registry:
        return download(registry[name_or_path], root=root)
    if name_or_path.startswith(("http://", "https://")):
        return download(name_or_path, root=root)
    if name_or_path.endswith((".pt", ".pth", ".tar", ".npz", ".npy")):
        raise FileNotFoundError(f"checkpoint file not found: {name_or_path}")
    raise RuntimeError(
        f"Model {name_or_path} not found; available models = {available_models()}"
    )
