"""The published checkpoints at full size through the port, on the card
(the port's counterpart of ``scripts/rehearse_fullsize.py``).

    python3 scripts/rehearse_fullsize_torch.py [LEG ...] [--device cuda]
                                               [--tiny]

``tests/test_torch_convert_fullsize.py`` holds the key grammars and the
converters on the CPU; this script runs the converted models. Legs, one
after another (default: all):

- ``unet``: the sdxl-turbo UNet with ``ip-adapter_sdxl_vit-h`` (2.92 B
  elements), ε at B 1 on 64 × 64 latents, a 77 × 2048 context, pooled,
  time-id and image embeddings, t = 999;
- ``vae``: the SDXL VAE, a 64 × 64 latent decoded to 512 × 512;
- ``text``: SDXL's two text towers (CLIP-L, bigG) on 77 tokens at B 2;
- ``openclip``: OpenCLIP ViT-H/14, 224² images at B 8 and the text tower
  on 77 tokens at B 2;
- ``git``: git-large-coco, its ViT-L/14 image encoder's 257 × 1024 grid of
  two 224² images and a 10-token greedy decode on it (B 2);
- ``prior``: the reference's ``diffusion_prior.pt``, the 50-step guided
  sample (guidance 5) of 200 rows, loaded through the ``prior-v1`` pickle
  ``cli generate --prior-params`` reads (the port's prior runs in fp32).

Each leg synthesizes its checkpoint from ``checkpoint_grammar_torch.py``
(seeded N(0, 0.02) drawn on the device, norm scales 1, handed over as fp16
host tensors, as a checkpoint reader hands them over), converts it on the
host with the port's converter, loads it ``strict=True`` into the module
built on ``meta`` and given memory on the device in bf16, runs the forward
(timed with CUDA events: one warm-up, then the median of ``REPS``), checks
that the output is finite and of its shape, and frees the device and the
host before the next leg. For the UNet's ε and the VAE's decode it also
loads the same converted weights in fp32 and holds each output row's
cosine to the bf16 one at ≥ ``COSINE``. Each leg prints one JSON line:
elements, synth / convert / load seconds, forward ms, peak device memory
and the host's peak RSS over the leg.

``--tiny`` runs the same legs at the port's tiny configurations (for a
check of this script where there is no card, ``--device cpu``). The card
host runs it as ``chip_smoke.py`` phase 18. Imports no JAX.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import pickle
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from eeg_image_decode_tpu_torch.core.config import PriorConfig  # noqa: E402
from eeg_image_decode_tpu_torch.gen.convert import (  # noqa: E402
    convert_sdxl_unet,
    convert_sdxl_vae,
)
from eeg_image_decode_tpu_torch.gen.text_encoder import (  # noqa: E402
    SDXLTextEncoder,
    SDXLTextEncoderConfig,
    convert_sdxl_text_encoders,
)
from eeg_image_decode_tpu_torch.gen.unet import (  # noqa: E402
    SDXLUNet,
    SDXLUNetConfig,
)
from eeg_image_decode_tpu_torch.gen.vae import VAE, VAEConfig  # noqa: E402
from eeg_image_decode_tpu_torch.models.clip_vit import (  # noqa: E402
    CLIPTextConfig,
    CLIPTextTower,
    CLIPVisionConfig,
    CLIPVisionTower,
)
from eeg_image_decode_tpu_torch.models.diffusion_prior import (  # noqa: E402
    convert_diffusion_prior,
)
from eeg_image_decode_tpu_torch.models.git_caption import (  # noqa: E402
    GITCaptioner,
    GITConfig,
    convert_git_causal_lm,
)
from eeg_image_decode_tpu_torch.train.prior import PriorPipe  # noqa: E402
from eeg_image_decode_tpu_torch.utils.convert import (  # noqa: E402
    flax_from_params,
)
from eeg_image_decode_tpu_torch.utils.convert_clip import (  # noqa: E402
    convert_hf_clip_vision,
    openclip_state_dicts,
)
from eeg_image_decode_tpu_torch.utils.device import (  # noqa: E402
    resolve_device,
)
from eeg_image_decode_tpu_torch.utils.profiling import PeakRSS  # noqa: E402


def _load_grammar():
    path = os.path.join(HERE, "checkpoint_grammar_torch.py")
    spec = importlib.util.spec_from_file_location("checkpoint_grammar_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


grammar = _load_grammar()
LEGS = ("unet", "vae", "text", "openclip", "git", "prior")
SEED = 20200220
REPS = 3
#: bf16 against fp32 on the same converted weights, per output row: the
#: limit ``chip_smoke.py`` phase 10 holds the seeded generator to
COSINE = 0.99
PRIOR_ROWS, PRIOR_STEPS, PRIOR_GUIDANCE = 200, 50, 5.0
GIT_TOKENS = 10

#: the port's tiny configurations, with their grammars' published-form
#: counterparts (``--tiny``)
_GIT_TINY = GITConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=2,
                      d_ff=64, max_position_embeddings=16, max_text_len=12,
                      num_visual_tokens=17, visual_dim=16, bos_token_id=1,
                      eos_token_id=2)
_GIT_VISION_TINY = CLIPVisionConfig(image_size=32, patch_size=8, width=16,
                                    layers=1, heads=2, embed_dim=16,
                                    act="quick_gelu")
SIZES = {
    "full": dict(
        unet=(SDXLUNetConfig.sdxl_turbo(),
              grammar.PUBLISHED["sdxl_turbo_unet"],
              grammar.PUBLISHED["ip_adapter_sdxl_vit_h"]),
        vae=(VAEConfig.sdxl(), grammar.PUBLISHED["sdxl_turbo_vae"]),
        latent=64,
        text=(SDXLTextEncoderConfig(), grammar.PUBLISHED["sdxl_clip_l"],
              grammar.PUBLISHED["sdxl_big_g"]),
        openclip=(CLIPVisionConfig.vit_h_14(), CLIPTextConfig.vit_h_14(),
                  grammar.PUBLISHED["open_clip_vit_h_14"]),
        git=(GITConfig.git_large_coco(), CLIPVisionConfig.git_vit_l_14(),
             grammar.PUBLISHED["git_large_coco"]),
        prior=(PriorConfig(), grammar.PUBLISHED["diffusion_prior"])),
    "tiny": dict(
        unet=(SDXLUNetConfig.tiny(),
              dict(grammar.PUBLISHED["sdxl_turbo_unet"],
                   block_out_channels=(32, 64), layers_per_block=1,
                   down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
                   up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
                   transformer_layers_per_block=(1, 1),
                   attention_head_dim=(2, 4), cross_attention_dim=64,
                   addition_time_embed_dim=32,
                   projection_class_embeddings_input_dim=64 + 6 * 32),
              dict(clip_embeddings_dim=64, clip_extra_context_tokens=2,
                   cross_attention_dim=64)),
        vae=(VAEConfig.tiny(),
             dict(grammar.PUBLISHED["sdxl_turbo_vae"],
                  block_out_channels=(16, 32), layers_per_block=1,
                  mid_block_add_attention=False)),
        latent=8,
        text=(SDXLTextEncoderConfig.tiny(),
              *(dict(vocab_size=64, hidden_size=32, intermediate_size=128,
                     num_hidden_layers=2, num_attention_heads=2,
                     max_position_embeddings=12, projection_dim=32,
                     hidden_act=act) for act in ("quick_gelu", "gelu"))),
        openclip=(CLIPVisionConfig.tiny(), CLIPTextConfig.tiny(),
                  dict(embed_dim=32,
                       vision_cfg=dict(image_size=32, layers=2, width=64,
                                       head_width=32, patch_size=8),
                       text_cfg=dict(context_length=12, vocab_size=64,
                                     width=32, heads=2, layers=2))),
        git=(_GIT_TINY, _GIT_VISION_TINY,
             dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                  num_hidden_layers=2, num_attention_heads=2,
                  max_position_embeddings=16,
                  vision_config=dict(hidden_size=16, intermediate_size=64,
                                     num_hidden_layers=1,
                                     num_attention_heads=2, image_size=32,
                                     patch_size=8))),
        prior=(PriorConfig.tiny(),
               dict(embed_dim=64, cond_dim=64, hidden_dim=(64, 32),
                    time_embed_dim=32))),
}


# ——— measurement ———


def forward_ms(fn, device: torch.device, reps: int = REPS
               ) -> tuple[float, object]:
    """(median ms of ``reps`` calls after one warm-up, the last output):
    CUDA events on the card, the host clock elsewhere."""
    out = fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def on_device(build, state_dict: dict, device: torch.device
              ) -> torch.nn.Module:
    """``build()`` on ``meta``, given memory on ``device``, loaded
    ``strict=True`` from ``state_dict``, in eval mode."""
    with torch.device("meta"):
        module = build()
    module.to_empty(device=device)
    module.load_state_dict(state_dict, strict=True)
    _sync(device)
    return module.eval()


def row_cosine(a: torch.Tensor, b: torch.Tensor) -> list[float]:
    a, b = a.float().flatten(1), b.float().flatten(1)
    return torch.nn.functional.cosine_similarity(a, b, dim=1).tolist()


def _finite(*tensors) -> bool:
    return all(bool(torch.isfinite(t.float()).all()) for t in tensors)


def _check(row: dict, ok: bool) -> dict:
    row["ok"] = bool(ok)
    if not ok:
        raise RuntimeError(f"full-size rehearsal, leg {row['leg']}: {row}")
    return row


# ——— the legs ———


def leg_unet(size: dict, device: torch.device) -> dict:
    cfg, pub, ip_pub = size["unet"]
    spec = grammar.unet_grammar(pub)
    ip_spec = grammar.ip_adapter_grammar(pub, ip_pub)
    (ckpt, ip), synth_s = _timed(lambda: (
        grammar.synth(spec, SEED, device), grammar.synth(ip_spec, SEED + 1,
                                                         device)))
    sd, convert_s = _timed(lambda: convert_sdxl_unet(ckpt, cfg,
                                                     ip_adapter_sd=ip))
    del ckpt, ip
    unet, load_s = _timed(lambda: on_device(
        lambda: SDXLUNet(cfg, dtype=torch.bfloat16), sd, device))
    g = torch.Generator(device=device).manual_seed(SEED + 2)
    n = size["latent"]

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    lat, ctx = randn(1, 4, n, n), randn(1, 77, cfg.cross_attention_dim)
    pooled, emb = randn(1, cfg.pooled_text_embed_dim), randn(
        1, cfg.ip_image_embed_dim)
    t = torch.full((1,), 999, dtype=torch.int64, device=device)
    tids = torch.tensor([[8.0 * n, 8.0 * n, 0, 0, 8.0 * n, 8.0 * n]],
                        device=device)
    with torch.no_grad():
        ms, e16 = forward_ms(lambda: unet(lat, t, ctx, pooled, tids, emb),
                             device)
        del unet
        unet32 = on_device(lambda: SDXLUNet(cfg, dtype=torch.float32), sd,
                           device)
        e32 = unet32(lat, t, ctx, pooled, tids, emb)
    cos = row_cosine(e16, e32)
    row = {"leg": "unet", "elements": grammar.elements(spec)
           + grammar.elements(ip_spec), "ip_adapter_elements":
           grammar.elements(ip_spec), "synth_s": synth_s,
           "convert_s": convert_s, "load_s": load_s, "forward_ms": ms,
           "eps_shape": list(e16.shape), "row_cosine_fp32": cos,
           "max_abs_diff_fp32": float((e16 - e32).abs().max())}
    return _check(row, _finite(e16, e32) and list(e16.shape) == [1, 4, n, n]
                  and min(cos) >= COSINE)


def leg_vae(size: dict, device: torch.device) -> dict:
    cfg, pub = size["vae"]
    spec = grammar.vae_grammar(pub)
    ckpt, synth_s = _timed(lambda: grammar.synth(spec, SEED + 3, device))
    sd, convert_s = _timed(lambda: convert_sdxl_vae(ckpt, cfg))
    del ckpt
    vae, load_s = _timed(lambda: on_device(
        lambda: VAE(cfg, dtype=torch.bfloat16), sd, device))
    n = size["latent"]
    z = torch.randn((1, cfg.latent_channels, n, n), device=device,
                    generator=torch.Generator(device=device).manual_seed(
                        SEED + 4))
    with torch.no_grad():
        ms, d16 = forward_ms(lambda: vae.decode(z), device)
        del vae
        d32 = on_device(lambda: VAE(cfg, dtype=torch.float32), sd,
                        device).decode(z)
    side = n * 2 ** (len(cfg.block_out_channels) - 1)
    cos = row_cosine(d16, d32)
    row = {"leg": "vae", "elements": grammar.elements(spec),
           "synth_s": synth_s, "convert_s": convert_s, "load_s": load_s,
           "forward_ms": ms, "image_shape": list(d16.shape),
           "row_cosine_fp32": cos,
           "max_abs_diff_fp32": float((d16 - d32).abs().max())}
    return _check(row, _finite(d16, d32)
                  and list(d16.shape) == [1, 3, side, side]
                  and min(cos) >= COSINE)


def _token_ids(g: torch.Generator, rows: int, length: int, vocab: int,
               device) -> torch.Tensor:
    """BPE-like ids: a prompt of random ids below the EOT id (the largest,
    ``vocab − 1``), EOT, then EOT padding."""
    ids = torch.randint(0, vocab - 1, (rows, length), generator=g,
                        device=device)
    ids[:, length // 3:] = vocab - 1
    return ids


def leg_text(size: dict, device: torch.device) -> dict:
    cfg, pub_l, pub_g = size["text"]
    specs = (grammar.clip_text_grammar(pub_l),
             grammar.clip_text_grammar(pub_g, projection=True))
    (ck1, ck2), synth_s = _timed(lambda: tuple(
        grammar.synth(s, SEED + 5 + i, device) for i, s in enumerate(specs)))
    sds, convert_s = _timed(lambda: convert_sdxl_text_encoders(ck1, ck2, cfg))
    del ck1, ck2

    def load():
        enc = SDXLTextEncoder(cfg, dtype=torch.bfloat16, device=device)
        enc.tower1.load_state_dict(sds["te1"], strict=True)
        enc.tower2.load_state_dict(sds["te2"], strict=True)
        _sync(device)
        return enc

    enc, load_s = _timed(load)
    g = torch.Generator(device=device).manual_seed(SEED + 7)
    length = cfg.clip_l.context_length
    ids = _token_ids(g, 2, length, cfg.clip_l.vocab_size, device)
    ms, (context, pooled) = forward_ms(lambda: enc.encode_tokens(ids, ids),
                                       device)
    row = {"leg": "text", "elements": sum(map(grammar.elements, specs)),
           "synth_s": synth_s, "convert_s": convert_s, "load_s": load_s,
           "forward_ms": ms, "context_shape": list(context.shape),
           "pooled_shape": list(pooled.shape)}
    return _check(row, _finite(context, pooled)
                  and list(context.shape) == [2, length, cfg.context_dim]
                  and list(pooled.shape) == [2, cfg.pooled_dim])


def leg_openclip(size: dict, device: torch.device) -> dict:
    vcfg, tcfg, pub = size["openclip"]
    spec = grammar.openclip_grammar(pub)
    ckpt, synth_s = _timed(lambda: grammar.synth(spec, SEED + 8, device))
    (vis, txt), convert_s = _timed(lambda: openclip_state_dicts(ckpt))
    del ckpt
    (vision, text), load_s = _timed(lambda: (
        on_device(lambda: CLIPVisionTower(vcfg, torch.bfloat16), vis,
                  device),
        on_device(lambda: CLIPTextTower(tcfg, torch.bfloat16), txt, device)))
    g = torch.Generator(device=device).manual_seed(SEED + 9)
    images = torch.randn((8, vcfg.image_size, vcfg.image_size, 3),
                         generator=g, device=device)
    ids = _token_ids(g, 2, tcfg.context_length, tcfg.vocab_size, device)
    with torch.no_grad():
        ms, feats = forward_ms(lambda: vision(images), device)
        text_ms, tfeats = forward_ms(lambda: text(ids), device)
    row = {"leg": "openclip", "elements": grammar.elements(spec),
           "synth_s": synth_s, "convert_s": convert_s, "load_s": load_s,
           "forward_ms": ms, "text_forward_ms": text_ms,
           "image_features_shape": list(feats.shape),
           "text_features_shape": list(tfeats.shape)}
    return _check(row, _finite(feats, tfeats)
                  and list(feats.shape) == [8, vcfg.embed_dim]
                  and list(tfeats.shape) == [2, tcfg.embed_dim])


def leg_git(size: dict, device: torch.device) -> dict:
    cfg, vcfg, pub = size["git"]
    spec = grammar.git_grammar(pub)
    ckpt, synth_s = _timed(lambda: grammar.synth(spec, SEED + 10, device))
    prefix = "git.image_encoder."

    def convert():
        _, dec = convert_git_causal_lm(ckpt, cfg)
        vis = convert_hf_clip_vision(
            {k[len(prefix):]: v for k, v in ckpt.items()
             if k.startswith(prefix)}, vcfg)
        return dec, vis

    (dec, vis), convert_s = _timed(convert)
    del ckpt
    (git, tower), load_s = _timed(lambda: (
        on_device(lambda: GITCaptioner(cfg, dtype=torch.bfloat16), dec,
                  device),
        on_device(lambda: CLIPVisionTower(vcfg, torch.bfloat16), vis,
                  device)))
    g = torch.Generator(device=device).manual_seed(SEED + 11)
    images = torch.randn((2, vcfg.image_size, vcfg.image_size, 3),
                         generator=g, device=device)
    with torch.no_grad():
        grid_ms, grid = forward_ms(lambda: tower(images, return_grid=True),
                                   device)
        ms, ids = forward_ms(lambda: git.generate(
            grid, max_new_tokens=GIT_TOKENS), device)
    n_grid = (vcfg.image_size // vcfg.patch_size) ** 2 + 1
    row = {"leg": "git", "elements": grammar.elements(spec),
           "synth_s": synth_s, "convert_s": convert_s, "load_s": load_s,
           "forward_ms": ms, "grid_forward_ms": grid_ms,
           "grid_shape": list(grid.shape), "ids_shape": list(ids.shape)}
    return _check(row, _finite(grid)
                  and list(grid.shape) == [2, n_grid, cfg.visual_dim]
                  and list(ids.shape) == [2, GIT_TOKENS + 1]
                  and bool(((ids >= 0) & (ids < cfg.vocab_size)).all()))


def leg_prior(size: dict, device: torch.device) -> dict:
    cfg, pub = size["prior"]
    spec = grammar.prior_grammar(pub)
    ckpt, synth_s = _timed(lambda: grammar.synth(spec, SEED + 12, device))
    sd, convert_s = _timed(lambda: convert_diffusion_prior(ckpt))
    del ckpt
    with tempfile.TemporaryDirectory(prefix="rehearse_prior_") as tmp:
        path = os.path.join(tmp, "diffusion_prior.pkl")

        def load():
            with open(path, "wb") as f:
                pickle.dump(flax_from_params(sd)["params"], f)
            return PriorPipe.from_checkpoint(path, default_cfg=cfg,
                                             device=device)

        pipe, load_s = _timed(load)
    g = torch.Generator(device=device).manual_seed(SEED + 13)
    c = torch.randn((PRIOR_ROWS, cfg.cond_dim), generator=g, device=device)
    keys = torch.arange(PRIOR_ROWS, dtype=torch.int64, device=device)
    ms, h = forward_ms(lambda: pipe.generate(
        c, num_inference_steps=PRIOR_STEPS, guidance_scale=PRIOR_GUIDANCE,
        row_keys=keys), device, reps=1)
    row = {"leg": "prior", "elements": grammar.elements(spec),
           "synth_s": synth_s, "convert_s": convert_s, "load_s": load_s,
           "forward_ms": ms, "rows": PRIOR_ROWS, "steps": PRIOR_STEPS,
           "sample_shape": list(h.shape), "dtype": "float32"}
    return _check(row, _finite(h)
                  and list(h.shape) == [PRIOR_ROWS, cfg.embed_dim])


LEG_FNS = {"unet": leg_unet, "vae": leg_vae, "text": leg_text,
           "openclip": leg_openclip, "git": leg_git, "prior": leg_prior}


def run_leg(name: str, device, tiny: bool = False) -> dict:
    """One leg, with its peak memory on the device and the host, then
    everything it held freed."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with PeakRSS() as host:
        row = LEG_FNS[name](SIZES["tiny" if tiny else "full"], device)
    row["host_peak_rss_gb"] = host.peak / 1e9
    if device.type == "cuda":
        row["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
    row["size"] = "tiny" if tiny else "full"
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return row


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("legs", nargs="*", metavar="LEG",
                   help=f"any of {', '.join(LEGS)} (default: all)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="the port's tiny configurations (a CPU check)")
    args = p.parse_args(argv)
    unknown = sorted(set(args.legs) - set(LEGS))
    if unknown:
        p.error(f"unknown legs {unknown}; choose from {LEGS}")
    rows = []
    for name in args.legs or LEGS:
        row = run_leg(name, args.device, args.tiny)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
