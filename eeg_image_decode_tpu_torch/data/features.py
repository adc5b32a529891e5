"""CLIP feature caches (counterpart of ``eeg_image_decode_tpu/data/features.py``).

Caches are framework-neutral ``.npz`` files keyed by (model, split, content
fingerprint of the image list), so switching image directories can never
silently reuse old features; a cache written by either package is read by
the other (``clip_cache_path`` is the same derivation). The serving gallery
is such a file (``img_features_test`` or ``img_features``, (N, 1024)).

:class:`CLIPFeatureEncoder` fills a cache through the port's CLIP towers
(``models/clip_vit.py``), the counterpart of ``FlaxCLIPFeatureEncoder``:
images are decoded, resized and cropped on the host exactly as the JAX
encoder does (PIL, bicubic on the shorter side, centre crop, /255), and
``clip_preprocess``, the towers and the L2 normalisation run on the device.
``compute_clip_features`` (the ``open_clip`` package and a download) is not
ported (ROADMAP.md).

:class:`VAELatentEncoder` and :func:`load_or_compute_vae_latents` fill the
low-level pipeline's SDXL-VAE latent cache (``sdxl-vae-{size}``, the JAX
cache name) through the port's VAE (``gen/vae.py``).
:func:`load_or_compute_git_grids` fills the captioning adapter's target
cache (``ViT-L-14-GIT-grid``, key ``grids``) through GIT's ViT-L/14 grid
tower (``CLIPFeatureEncoder.encode_grids``).
"""

from __future__ import annotations

import hashlib
import os
import time

import numpy as np
import torch

from eeg_image_decode_tpu_torch.models.clip_vit import (
    CLIPTextTower,
    CLIPVisionTower,
    clip_preprocess,
)
from eeg_image_decode_tpu_torch.utils.convert_clip import (
    clip_state_dict_from_flax,
)
from eeg_image_decode_tpu_torch.utils.device import resolve_device


def _fingerprint(items: list[str]) -> str:
    h = hashlib.sha256()
    for it in items:
        h.update(it.encode())
        h.update(b"\0")
    return h.hexdigest()[:16]


def cache_path(cache_dir: str, model_name: str, split: str,
               image_paths: list[str]) -> str:
    fp = _fingerprint(image_paths)
    safe = model_name.replace("/", "-")
    return os.path.join(cache_dir, f"{safe}_features_{split}_{fp}.npz")


def clip_cache_path(cache_dir: str, split: str, image_paths: list[str], *,
                    model_name: str = "ViT-H-14",
                    normalize_img: bool = True) -> str:
    """The cache file of one (model, normalisation, split, image list): the
    single source of the key derivation."""
    tag = f"{model_name}-{'n' if normalize_img else 'r'}"
    return cache_path(cache_dir, tag, split, image_paths)


def save_features(path: str, *, img_features: np.ndarray,
                  text_features: np.ndarray, **extra) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, img_features=np.asarray(img_features, np.float32),
             text_features=np.asarray(text_features, np.float32), **extra)


def load_features(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_image(path: str, size: int) -> np.ndarray:
    """One image → (size, size, 3) fp32 in [0, 1]: RGB, the shorter side
    resized to ``size`` (bicubic), then the centre crop (the JAX encoder's
    ``_load_images``, OpenCLIP's eval transform)."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        scale = size / min(w, h)
        im = im.resize((round(w * scale), round(h * scale)), Image.BICUBIC)
        left = (im.size[0] - size) // 2
        top = (im.size[1] - size) // 2
        im = im.crop((left, top, left + size, top + size))
        return np.asarray(im, np.float32) / 255.0


class CLIPFeatureEncoder:
    """CLIP feature extraction through the port's towers, on ``device``.

    ``stats`` holds the host-clock split of the last :meth:`encode_images` /
    :meth:`encode_grids` call, per batch: ``decode_s`` (host decode and
    resize) and ``device_s`` (copy to the device, the tower, the copy back,
    which ends each batch synchronised), with ``images``."""

    def __init__(self, vision_tower, text_tower=None, tokenizer=None, *,
                 device=None):
        self.device = resolve_device(device)
        self.vision_tower = vision_tower.to(self.device).eval()
        self.text_tower = (None if text_tower is None
                           else text_tower.to(self.device).eval())
        self.tokenizer = tokenizer
        self.stats: dict = {}

    def _load_images(self, paths: list[str]) -> np.ndarray:
        size = self.vision_tower.config.image_size
        out = np.empty((len(paths), size, size, 3), np.float32)
        for i, p in enumerate(paths):
            out[i] = load_image(p, size)
        return out

    @torch.inference_mode()
    def _encode(self, image_paths: list[str], fn, batch_size: int
                ) -> np.ndarray:
        """``fn`` over the preprocessed images of each batch, as numpy. The
        last batch is not padded: only real rows are computed."""
        chunks, decode_s, device_s = [], [], []
        for i in range(0, len(image_paths), batch_size):
            t0 = time.perf_counter()
            imgs = self._load_images(image_paths[i:i + batch_size])
            t1 = time.perf_counter()
            x = torch.from_numpy(imgs).to(self.device)
            chunks.append(fn(clip_preprocess(x)).float().cpu().numpy())
            decode_s.append(t1 - t0)
            device_s.append(time.perf_counter() - t1)
        self.stats = {"images": len(image_paths), "decode_s": decode_s,
                      "device_s": device_s}
        return np.concatenate(chunks, 0).astype(np.float32)

    def encode_images(self, image_paths: list[str], *, normalize: bool = True,
                      batch_size: int = 20) -> np.ndarray:
        """Images → (N, embed_dim) features, L2-normalised unless
        ``normalize=False``."""
        def fwd(x):
            feats = self.vision_tower(x)
            if normalize:
                feats = feats / torch.linalg.norm(feats, dim=-1, keepdim=True)
            return feats

        return self._encode(image_paths, fwd, batch_size)

    def encode_grids(self, image_paths: list[str], *,
                     batch_size: int = 20) -> np.ndarray:
        """Images → (N, 1 + grid², width) token grids (``return_grid``)."""
        return self._encode(
            image_paths, lambda x: self.vision_tower(x, return_grid=True),
            batch_size)

    @torch.inference_mode()
    def encode_texts(self, prompts: list[str]) -> np.ndarray:
        """Prompts → (N, embed_dim) L2-normalised features, in one batch."""
        if self.text_tower is None or self.tokenizer is None:
            raise ValueError("text encoding needs text_tower + tokenizer")
        ids = torch.from_numpy(self.tokenizer(prompts)).to(self.device)
        feats = self.text_tower(ids)
        feats = feats / torch.linalg.norm(feats, dim=-1, keepdim=True)
        return feats.float().cpu().numpy()

    def __call__(self, image_paths, text_prompts, *, normalize_img=True,
                 batch_size=20):
        img = self.encode_images(image_paths, normalize=normalize_img,
                                 batch_size=batch_size)
        txt = self.encode_texts(text_prompts)
        return img, txt


def build_clip_encoder(params: dict, vision_config, text_config, tokenizer,
                       *, dtype=torch.float32, device=None
                       ) -> CLIPFeatureEncoder:
    """``{'vision': tree, 'text': tree}`` (the JAX towers' param trees as
    numpy, ``utils/convert_clip.py::load_clip_params``) → the encoder, its
    towers built on ``device`` in ``dtype`` and loaded strictly."""
    dev = resolve_device(device)
    with torch.device(dev):
        vt = CLIPVisionTower(vision_config, dtype=dtype)
        tt = CLIPTextTower(text_config, dtype=dtype)
    vt.load_state_dict(clip_state_dict_from_flax(params["vision"], "vision"),
                       strict=True)
    tt.load_state_dict(clip_state_dict_from_flax(params["text"], "text"),
                       strict=True)
    return CLIPFeatureEncoder(vt, tt, tokenizer, device=dev)


def load_or_compute_clip_features(
    cache_dir: str,
    split: str,
    image_paths: list[str],
    text_prompts: list[str],
    *,
    encoder: CLIPFeatureEncoder,
    model_name: str = "ViT-H-14",
    normalize_img: bool = True,
    batch_size: int = 20,
) -> dict[str, np.ndarray]:
    """Cache-or-encode. Image features are L2-normalised for retrieval; pass
    ``normalize_img=False`` for the reconstruction pipeline's raw embeddings
    (ref ``Generation/eegdatasets_leaveone.py:318``). The cache file is
    :func:`clip_cache_path` of the same arguments, the JAX package's."""
    path = clip_cache_path(cache_dir, split, image_paths,
                           model_name=model_name, normalize_img=normalize_img)
    if os.path.exists(path):
        return load_features(path)
    img, txt = encoder(image_paths, text_prompts, normalize_img=normalize_img,
                       batch_size=batch_size)
    save_features(path, img_features=img, text_features=txt)
    return {"img_features": img, "text_features": txt}


class VAELatentEncoder:
    """Image files → SDXL-VAE latents through the port's VAE (the
    counterpart of ``FlaxVAELatentEncoder``): each image resized to
    ``image_size``² (PIL bicubic, no crop), mapped to [-1, 1] and encoded
    deterministically (the distribution's mean × scaling factor), giving
    NHWC (N, size/8, size/8, 4) fp32 latents, the JAX cache's layout.
    ``vae``: a ``gen/vae.py::VAE`` with weights, moved to ``device``
    (default: the CUDA card; raises without one)."""

    def __init__(self, vae, *, image_size: int = 512, device=None):
        self.device = resolve_device(device)
        self.vae = vae.to(self.device).eval()
        self.image_size = image_size

    def _load_images(self, paths: list[str]) -> np.ndarray:
        from PIL import Image

        size = self.image_size
        out = np.empty((len(paths), size, size, 3), np.float32)
        for i, p in enumerate(paths):
            with Image.open(p) as im:
                im = im.convert("RGB").resize((size, size), Image.BICUBIC)
                out[i] = np.asarray(im, np.float32) / 255.0
        return out

    @torch.inference_mode()
    def encode_images(self, image_paths: list[str], *,
                      batch_size: int = 8) -> np.ndarray:
        chunks = []
        for i in range(0, len(image_paths), batch_size):
            x = torch.from_numpy(self._load_images(
                image_paths[i:i + batch_size])).to(self.device)
            lat = self.vae.encode((x * 2.0 - 1.0).permute(0, 3, 1, 2))
            chunks.append(lat.float().permute(0, 2, 3, 1).cpu().numpy())
        return np.concatenate(chunks, 0)


def load_or_compute_vae_latents(cache_dir: str, split: str,
                                image_paths: list[str], *,
                                encoder: VAELatentEncoder,
                                batch_size: int = 8) -> np.ndarray:
    """Content-keyed cache-or-encode for VAE latents, the analogue of
    :func:`load_or_compute_clip_features` for the low-level pipeline; the
    file is the JAX package's (``sdxl-vae-{size}``), key ``latents``."""
    path = cache_path(cache_dir, f"sdxl-vae-{encoder.image_size}", split,
                      image_paths)
    if os.path.exists(path):
        return load_features(path)["latents"]
    latents = encoder.encode_images(image_paths, batch_size=batch_size)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, latents=latents)
    return latents


def load_or_compute_git_grids(cache_dir: str, split: str,
                              image_paths: list[str], *,
                              encoder: CLIPFeatureEncoder,
                              batch_size: int = 20) -> np.ndarray:
    """Content-keyed cache-or-encode of GIT visual-token grids (N, 257,
    1024): the production step for the reference's external
    ``ViT-L-14_features_GIT_{train,test}.pt`` caches
    (``Generation/image_adapter.ipynb`` cell 1). ``encoder`` wraps GIT's
    frozen CLIP ViT-L vision tower (``CLIPVisionConfig.git_vit_l_14()``);
    the file is the JAX package's (``ViT-L-14-GIT-grid``), key ``grids``."""
    path = cache_path(cache_dir, "ViT-L-14-GIT-grid", split, image_paths)
    if os.path.exists(path):
        return load_features(path)["grids"]
    grids = encoder.encode_grids(image_paths, batch_size=batch_size)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, grids=grids)
    return grids
