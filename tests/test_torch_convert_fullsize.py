"""The published checkpoints at full size through the port's converters.

``scripts/checkpoint_grammar_torch.py`` writes each published checkpoint's
key grammar (``{name: shape}``) from its own configuration. Per family:

(a) the grammar is the published one: equal, key for key and shape for
    shape, to JAX's enumerators (``tests/test_convert_fullsize.py``: the
    UNet, the IP-Adapter, the VAE, OpenCLIP), to transformers' classes
    built on ``meta`` (the two SDXL text towers, GIT; the ``position_ids``
    buffers those classes no longer save are held to the classes' buffers)
    and to the reference prior class (``tests/test_prior_convert.py``);
(b) the port's converter accounts for every checkpoint element, less the
    skips named in ``SKIPS`` and plus the identity projections it adds for
    towers published without one (SDXL's ``text_encoder``, GIT's image
    encoder), and its output loads ``strict=True`` into the module built
    on ``meta`` at the published config;
(c) its key set equals the JAX converter's output on the same checkpoint,
    mapped into the port's names by the loader the port reads that JAX
    tree with (``utils/convert.py::params_from_flax`` for the generator and
    the prior; ``clip_state_dict_from_flax`` for the CLIP towers and
    ``git_state_dict_from_flax`` for GIT, whose trees ``params_from_flax``
    does not take), name for name and shape for shape.

The checkpoints are zeros: only names and shapes are under test here (the
tiny parity tests hold the values). The port's converters take fp32
tensors over lazily mapped zero pages, which they hand on without a copy;
the JAX converters take fp16 zeros, and the SDXL UNet (2.57 B + 0.35 B
elements, 11.7 GB as the fp32 copies ``gen/convert.py::_take`` makes)
converts on ``meta`` in the port and from zero-byte arrays in JAX. Its
conversion with values runs on the card host: ``chip_smoke.py`` phase 18
(``scripts/rehearse_fullsize_torch.py``).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import test_convert_fullsize as jax_fullsize  # noqa: E402
import test_prior_convert as prior_case  # noqa: E402
from eeg_image_decode_tpu.gen import convert as jax_gen_convert  # noqa: E402
from eeg_image_decode_tpu.gen import text_encoder as jax_text  # noqa: E402
from eeg_image_decode_tpu.gen.unet import (  # noqa: E402
    SDXLUNetConfig as JaxUNetConfig,
)
from eeg_image_decode_tpu.gen.vae import (  # noqa: E402
    VAEConfig as JaxVAEConfig,
)
from eeg_image_decode_tpu.models import clip_vit as jax_clip  # noqa: E402
from eeg_image_decode_tpu.models import (  # noqa: E402
    diffusion_prior as jax_prior,
)
from eeg_image_decode_tpu.models import git_caption as jax_git  # noqa: E402
from eeg_image_decode_tpu.utils import (  # noqa: E402
    convert_clip as jax_convert_clip,
)
from eeg_image_decode_tpu_torch.gen.convert import (  # noqa: E402
    convert_sdxl_unet,
    convert_sdxl_vae,
)
from eeg_image_decode_tpu_torch.gen.text_encoder import (  # noqa: E402
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
    DiffusionPriorUNet,
    convert_diffusion_prior,
)
from eeg_image_decode_tpu_torch.models.git_caption import (  # noqa: E402
    GITCaptioner,
    GITConfig,
    convert_git_causal_lm,
)
from eeg_image_decode_tpu_torch.utils.convert import (  # noqa: E402
    git_state_dict_from_flax,
    params_from_flax,
)
from eeg_image_decode_tpu_torch.utils.convert_clip import (  # noqa: E402
    clip_state_dict_from_flax,
    convert_hf_clip_vision,
    openclip_state_dicts,
)
from torch_port_case import two_threads  # noqa: E402, F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_grammar():
    path = os.path.join(REPO, "scripts", "checkpoint_grammar_torch.py")
    spec = importlib.util.spec_from_file_location("checkpoint_grammar_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


grammar = _load_grammar()
PUB = grammar.PUBLISHED
PRIOR_DIMS = (1024, 512, 256, 128, 64)

#: checkpoint keys a port converter leaves out on purpose, and why
SKIPS = {
    "logit_scale": "OpenCLIP's contrastive temperature: neither tower "
                   "uses it",
    "position_ids": "transformers' int64 index buffer (saved before its "
                    "4.31 release): every module rebuilds it",
    "git.image_encoder.": "GIT's vision tower: convert_git_causal_lm takes "
                          "the decoder, convert_hf_clip_vision the tower",
}


def _skipped(name: str) -> bool:
    """Is ``name`` one of ``SKIPS``: the key itself, a buffer of that name,
    or a key under that prefix?"""
    return any(name == s or name.endswith("." + s)
               or (s.endswith(".") and name.startswith(s)) for s in SKIPS)


def _shapes(sd: dict) -> dict:
    return {k: tuple(v.shape) for k, v in sd.items()}


def _port_ckpt(spec: dict) -> dict:
    """The checkpoint as fp32 tensors over zero pages the OS maps lazily:
    a converter that hands them on costs no memory."""
    return {k: torch.from_numpy(np.zeros(s, np.float32))
            for k, s in spec.items()}


def _jax_ckpt(spec: dict, dtype=np.float16) -> dict:
    return {k: np.zeros(s, dtype) for k, s in spec.items()}


def _views(tree):
    """A JAX tree's leaves as fp32 zero views of their shapes (no memory
    until a mapper copies them)."""
    if isinstance(tree, dict):
        return {k: _views(v) for k, v in tree.items()}
    return np.broadcast_to(np.zeros((), np.float32), np.shape(tree))


def _same(got: dict, want: dict, what: str) -> None:
    got = {k: tuple(v) for k, v in got.items()}
    want = {k: tuple(v) for k, v in want.items()}
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    wrong = {k: (got[k], want[k]) for k in want.keys() & got.keys()
             if got[k] != want[k]}
    assert not (missing or extra or wrong), (
        f"{what}: missing {missing[:6]} extra {extra[:6]} shapes "
        f"{dict(list(wrong.items())[:6])}")


def _accounted(converted: dict, spec: dict, injected: int = 0) -> None:
    """(b): every checkpoint element, less the named skips, is in the
    converted dict, and nothing else is but ``injected`` elements of an
    identity projection."""
    kept = {k: s for k, s in spec.items() if not _skipped(k)}
    assert grammar.elements(converted) == grammar.elements(kept) + injected


def _load_on_meta(module_fn, sd: dict) -> None:
    with torch.device("meta"):
        module = module_fn()
    module.load_state_dict(sd, strict=True, assign=True)


def _without_position_ids(spec: dict) -> dict:
    return {k: s for k, s in spec.items() if not k.endswith("position_ids")}


def _hf_git_config():
    c, v = PUB["git_large_coco"], PUB["git_large_coco"]["vision_config"]
    return transformers.GitConfig(
        vision_config=transformers.GitVisionConfig(**v).to_dict(),
        **{k: c[k] for k in ("vocab_size", "hidden_size", "intermediate_size",
                             "num_hidden_layers", "num_attention_heads",
                             "max_position_embeddings")})


def _hf_text_config(c: dict):
    return transformers.CLIPTextConfig(**c)


# ——— (a) the grammars are the published ones ———


def _meta_state(model_fn):
    """A transformers class on ``meta``: (state_dict shapes, buffer
    shapes)."""
    with torch.device("meta"):
        model = model_fn()
    return (_shapes(model.state_dict()),
            {k: tuple(b.shape) for k, b in model.named_buffers()})


def _against_transformers(spec: dict, model_fn, what: str) -> None:
    state, buffers = _meta_state(model_fn)
    # transformers ≥ 4.31 no longer saves the position_ids buffers: the
    # rest against its state_dict, the buffers against the module's own
    _same(_without_position_ids(spec), _without_position_ids(state), what)
    pos = {k: s for k, s in spec.items() if k.endswith("position_ids")}
    assert pos and all(buffers[k] == s for k, s in pos.items()), (pos,
                                                                  buffers)


@pytest.mark.parametrize("family", [
    "unet", "ip_adapter", "vae", "openclip", "te1", "te2", "git", "prior"])
def test_grammar_is_the_published_layout(family):
    if family == "unet":
        _same(grammar.unet_grammar(),
              jax_fullsize.unet_checkpoint_spec(JaxUNetConfig.sdxl_turbo()),
              family)
    elif family == "ip_adapter":
        spec = grammar.ip_adapter_grammar()
        _same(spec, jax_fullsize.ip_adapter_spec(JaxUNetConfig.sdxl_turbo()),
              family)
        ids = sorted(int(k.split(".")[1]) for k in spec
                     if k.endswith("to_k_ip.weight"))
        assert ids == list(range(1, 140, 2))  # 70 cross-attentions
    elif family == "vae":
        _same(grammar.vae_grammar(),
              jax_fullsize.vae_checkpoint_spec(JaxVAEConfig.sdxl()), family)
    elif family == "openclip":
        _same(grammar.openclip_grammar(), jax_fullsize.openclip_spec(
            jax_clip.CLIPVisionConfig.vit_h_14(),
            jax_clip.CLIPTextConfig.vit_h_14()), family)
    elif family == "te1":
        _against_transformers(
            grammar.clip_text_grammar(PUB["sdxl_clip_l"]),
            lambda: transformers.CLIPTextModel(
                _hf_text_config(PUB["sdxl_clip_l"])), family)
    elif family == "te2":
        _against_transformers(
            grammar.clip_text_grammar(PUB["sdxl_big_g"], projection=True),
            lambda: transformers.CLIPTextModelWithProjection(
                _hf_text_config(PUB["sdxl_big_g"])), family)
    elif family == "git":
        _against_transformers(
            grammar.git_grammar(),
            lambda: transformers.GitForCausalLM(_hf_git_config()), family)
    else:
        ref = prior_case._RefPriorUNet(embed_dim=1024, cond_dim=1024,
                                       hidden_dim=PRIOR_DIMS,
                                       time_embed_dim=512)
        _same(grammar.prior_grammar(), _shapes(ref.state_dict()), family)


# ——— (b) and (c): every element through each converter ———


def _jax_unet_names() -> dict:
    """(c) for the UNet: JAX's converter on zero-byte arrays of the
    grammar's shapes (it moves no values), then ``params_from_flax`` one
    top-level module at a time, so no more than one module's fp32 copy
    lives at once."""
    cfg = JaxUNetConfig.sdxl_turbo()
    v0 = np.dtype("V0")
    tree = jax_gen_convert.convert_sdxl_unet(
        _jax_ckpt(grammar.unet_grammar(), v0), cfg,
        ip_adapter_sd=_jax_ckpt(grammar.ip_adapter_grammar(), v0))
    names = {}
    for module, sub in _views(tree).items():
        for k, v in params_from_flax({"unet": {module: sub}}).items():
            names[k.removeprefix("unet.")] = tuple(v.shape)
    return names


def test_sdxl_unet_and_ip_adapter_convert_every_element_on_meta():
    """The 2.57 B-element UNet and the 70-entry IP-Adapter, on ``meta``:
    names, shapes, the accounting, a strict load, and JAX's key set."""
    cfg = SDXLUNetConfig.sdxl_turbo()
    spec, ip_spec = grammar.unet_grammar(), grammar.ip_adapter_grammar()

    def meta(s):
        return {k: torch.empty(v, dtype=torch.float16, device="meta")
                for k, v in s.items()}

    sd = convert_sdxl_unet(meta(spec), cfg, ip_adapter_sd=meta(ip_spec))
    assert all(v.is_meta and v.dtype == torch.float32 for v in sd.values())
    assert grammar.elements(sd) == (grammar.elements(spec)
                                    + grammar.elements(ip_spec))
    _load_on_meta(lambda: SDXLUNet(cfg), sd)
    _same(_shapes(sd), _jax_unet_names(), "unet against JAX")


def test_sdxl_unet_refuses_an_ip_adapter_in_spatial_order():
    """An IP-Adapter whose entries follow down, mid, up (not the
    processors' registration order, down, up, mid) puts a 640-wide entry
    on a 1280-wide cross-attention at full size: the converter refuses."""
    cfg = SDXLUNetConfig.sdxl_turbo()
    widths = grammar.cross_attention_widths()
    n_down, n_mid = 24, 10  # SDXL: 4 + 20 down, 30 + 6 up, 10 mid
    spatial = widths[:n_down] + widths[-n_mid:] + widths[n_down:-n_mid]
    assert spatial != widths
    ip = {k: s for k, s in grammar.ip_adapter_grammar().items()
          if k.startswith("image_proj.")}
    for n, w in enumerate(spatial):
        for kv in ("k", "v"):
            ip[f"ip_adapter.{2 * n + 1}.to_{kv}_ip.weight"] = (w, 2048)

    def meta(s):
        return {k: torch.empty(v, device="meta") for k, v in s.items()}

    with pytest.raises(ValueError, match="enumeration-order mismatch"):
        convert_sdxl_unet(meta(grammar.unet_grammar()), cfg,
                          ip_adapter_sd=meta(ip))


def test_sdxl_vae_converts_every_element():
    spec = grammar.vae_grammar()
    sd = convert_sdxl_vae(_port_ckpt(spec), VAEConfig.sdxl())
    _accounted(sd, spec)
    _load_on_meta(lambda: VAE(VAEConfig.sdxl()), sd)
    tree = jax_gen_convert.convert_sdxl_vae(_jax_ckpt(spec),
                                            JaxVAEConfig.sdxl())
    jax_names = {k.removeprefix("vae."): tuple(v.shape) for k, v in
                 params_from_flax({"vae": _views(tree)}).items()}
    _same(_shapes(sd), jax_names, "vae against JAX")


def test_sdxl_text_encoders_convert_every_element():
    """CLIP-L (12 layers, no projection: an identity is injected) and
    bigG (32 layers, its projection from the checkpoint), with the
    position_ids buffers of files saved before transformers 4.31."""
    cfg = SDXLTextEncoderConfig()
    specs = {"te1": grammar.clip_text_grammar(PUB["sdxl_clip_l"]),
             "te2": grammar.clip_text_grammar(PUB["sdxl_big_g"],
                                              projection=True)}
    assert all("text_model.embeddings.position_ids" in s
               for s in specs.values())
    towers = {"te1": cfg.clip_l, "te2": cfg.big_g}
    out = convert_sdxl_text_encoders(_port_ckpt(specs["te1"]),
                                     _port_ckpt(specs["te2"]), cfg)
    names = {}
    for te, tower_cfg in towers.items():
        sd = out.pop(te)
        injected = tower_cfg.width ** 2 if te == "te1" else 0
        _accounted(sd, specs[te], injected)
        if injected:
            assert torch.equal(sd["text_projection"],
                               torch.eye(tower_cfg.width))
        _load_on_meta(lambda: CLIPTextTower(tower_cfg), sd)
        names[te] = _shapes(sd)
        del sd
    jax_cfg = jax_text.SDXLTextEncoderConfig()
    for te, tower_cfg in (("te1", jax_cfg.clip_l), ("te2", jax_cfg.big_g)):
        tree = _views(jax_text.convert_hf_clip_text(_jax_ckpt(specs[te]),
                                                    tower_cfg))
        _same(names[te], _shapes(clip_state_dict_from_flax(tree, "text")),
              f"{te} against JAX")


def test_openclip_vit_h_converts_every_element():
    """OpenCLIP ViT-H/14: the 32-layer vision and 24-layer text towers;
    ``logit_scale`` is the one key left over."""
    spec = grammar.openclip_grammar()
    vision, text = openclip_state_dicts(_port_ckpt(spec))
    _accounted({**{f"visual.{k}": v for k, v in vision.items()}, **text},
               spec)
    _load_on_meta(lambda: CLIPVisionTower(CLIPVisionConfig.vit_h_14()),
                  vision)
    _load_on_meta(lambda: CLIPTextTower(CLIPTextConfig.vit_h_14()), text)
    ckpt = _jax_ckpt(spec)
    for kind, sd, convert, jax_cfg in (
            ("vision", vision, jax_convert_clip.convert_openclip_vision,
             jax_clip.CLIPVisionConfig.vit_h_14()),
            ("text", text, jax_convert_clip.convert_openclip_text,
             jax_clip.CLIPTextConfig.vit_h_14())):
        tree = _views(convert(ckpt, jax_cfg))
        _same(_shapes(sd), _shapes(clip_state_dict_from_flax(tree, kind)),
              f"openclip {kind} against JAX")


def test_git_large_coco_converts_every_element():
    """git-large-coco's decoder through ``convert_git_causal_lm`` and its
    ViT-L/14 image encoder through ``convert_hf_clip_vision`` (an identity
    ``proj`` injected), both with the position_ids buffers of the
    published (2022) file."""
    spec = grammar.git_grammar()
    ckpt = _port_ckpt(spec)
    cfg, dec = convert_git_causal_lm(ckpt, GITConfig.git_large_coco())
    assert cfg == GITConfig.git_large_coco()
    _accounted(dec, spec)
    _load_on_meta(lambda: GITCaptioner(cfg), dec)

    prefix = "git.image_encoder."
    vis_spec = {k.removeprefix(prefix): s for k, s in spec.items()
                if k.startswith(prefix)}
    vis_cfg = CLIPVisionConfig.git_vit_l_14()
    vis = convert_hf_clip_vision(
        {k.removeprefix(prefix): v for k, v in ckpt.items()
         if k.startswith(prefix)}, vis_cfg)
    _accounted(vis, vis_spec, injected=vis_cfg.width ** 2)
    _load_on_meta(lambda: CLIPVisionTower(vis_cfg), vis)

    jax_dec = jax_git.convert_git_causal_lm(
        _jax_ckpt({k: s for k, s in spec.items()
                   if not k.startswith(prefix)}),
        jax_git.GITConfig.git_large_coco())
    _same(_shapes(dec), _shapes(git_state_dict_from_flax(_views(jax_dec))),
          "git decoder against JAX")
    jax_vis = jax_convert_clip.convert_hf_clip_vision(
        _jax_ckpt(vis_spec), jax_clip.CLIPVisionConfig.git_vit_l_14())
    _same(_shapes(vis), _shapes(clip_state_dict_from_flax(_views(jax_vis),
                                                          "vision")),
          "git vision tower against JAX")


def test_git_converter_leaves_out_the_position_ids_buffers():
    """The repair this file found: ``convert_git_causal_lm`` handed
    ``git.embeddings.position_ids`` on, and the strict load of a file saved
    before transformers 4.31 failed on it."""
    spec = grammar.git_grammar()
    _, dec = convert_git_causal_lm(_port_ckpt(spec),
                                   GITConfig.git_large_coco())
    assert not any(k.endswith("position_ids") for k in dec)
    _, without = convert_git_causal_lm(
        _port_ckpt(grammar.git_grammar(position_ids=False)),
        GITConfig.git_large_coco())
    assert _shapes(without) == _shapes(dec)


def test_diffusion_prior_converts_every_element():
    """The reference's ``diffusion_prior.pt`` at hidden dims (1024, 512,
    256, 128, 64)."""
    spec = grammar.prior_grammar()
    sd = convert_diffusion_prior(_port_ckpt(spec))
    _accounted(sd, spec)
    _load_on_meta(lambda: DiffusionPriorUNet(hidden_dims=PRIOR_DIMS), sd)
    tree = jax_prior.convert_diffusion_prior(_jax_ckpt(spec))
    _same(_shapes(sd), _shapes(params_from_flax({"params": _views(tree)})),
          "prior against JAX")

