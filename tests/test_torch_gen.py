"""The port's generator against the JAX package, in fp32 on the CPU.

- ``ops/euler.py``: timesteps equal, σ within 1 ulp, the ancestral and
  plain steps, ``add_noise`` and the img2img truncation ≤ 1e-6;
- ``gen/unet.py`` at ``tiny()`` widths, with and without ``image_embeds``
  and ``pooled``: ε ≤ 1e-4 of max|ε|;
- ``gen/vae.py`` (the tiny VAE, and once with the mid attention): encode
  and decode ≤ 1e-4;
- ``gen/sdxl.py::Generator4Embeds.generate`` fed JAX's own ``row_noise``
  draws through ``init_noise``/``step_noises``: guidance 0 from noise, and
  guidance > 0 from img2img init latents, images ≤ 1e-4;
  ``encode_init_image`` ≤ 1e-4 of the latents' scale;
- ``gen/text_encoder.py`` ≤ 1e-5, and its transformers-layout converter
  against the JAX one, bit for bit;
- ``gen/convert.py`` against JAX ``convert_sdxl_unet``/``convert_sdxl_vae``
  on one random diffusers-keyed dict, bit for bit, and a mis-ordered
  IP-Adapter dict refused by both;
- the full-width ``sdxl_turbo()`` UNet and ``sdxl()`` VAE, built on
  ``meta``, name for name and shape for shape against ``jax.eval_shape`` of
  the JAX init mapped through ``utils/convert.py``'s generator map.

JAX weights: the JAX trees' shapes from ``jax.eval_shape``, every leaf drawn
from a numpy seed, carried into the port by ``params_from_flax``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg_image_decode_tpu.gen import convert as jconvert
from eeg_image_decode_tpu.gen import sdxl as jsdxl
from eeg_image_decode_tpu.gen import text_encoder as jte
from eeg_image_decode_tpu.gen import unet as junet
from eeg_image_decode_tpu.gen import vae as jvae
from eeg_image_decode_tpu.ops import ddpm as jddpm
from eeg_image_decode_tpu.ops import euler as jeuler
from eeg_image_decode_tpu_torch.gen import convert as pconvert
from eeg_image_decode_tpu_torch.gen import sdxl as psdxl
from eeg_image_decode_tpu_torch.gen import text_encoder as pte
from eeg_image_decode_tpu_torch.gen import unet as punet
from eeg_image_decode_tpu_torch.gen import vae as pvae
from eeg_image_decode_tpu_torch.ops.euler import EulerDiscreteSchedule
from eeg_image_decode_tpu_torch.utils.convert import (
    flax_from_params,
    generator_arrays_from_flax,
    params_from_flax,
)
from torch_port_case import randomize


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the host's
    cores, and each PyTorch process would otherwise take them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _random_tree(init_fn, seed):
    """The param tree of ``init_fn`` (shapes from ``jax.eval_shape``, no
    flax init run), every leaf redrawn from a numpy seed."""
    shapes = jax.eval_shape(init_fn)["params"]
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    return randomize(zeros, seed)


def _nchw(a):
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _part(sd, part):
    return {k[len(part) + 1:]: v for k, v in sd.items()
            if k.startswith(part + ".")}


# ——— ops/euler.py ———


@pytest.mark.parametrize("steps,strength", [(1, 1.0), (4, 1.0), (4, 0.5),
                                            (50, 1.0), (50, 0.7)])
def test_euler_schedule_matches_jax(steps, strength):
    js = jeuler.EulerDiscreteSchedule(ancestral=True)
    ps = EulerDiscreteSchedule(ancestral=True)
    np.testing.assert_array_equal(ps.alphas_cumprod.numpy(),
                                  np.asarray(js.alphas_cumprod))
    jt, jsig = js.timesteps_and_sigmas(steps, strength=strength)
    pt, psig = ps.timesteps_and_sigmas(steps, strength=strength)
    np.testing.assert_array_equal(pt, np.asarray(jt))
    np.testing.assert_array_max_ulp(psig.numpy(), np.asarray(jsig), maxulp=1)
    assert len(pt) == (max(round(steps * strength), 1) if strength < 1
                       else steps)
    np.testing.assert_allclose(
        float(ps.init_noise_sigma(psig)),
        float(js.init_noise_sigma(jsig)), rtol=1e-6)

    rng = np.random.default_rng(steps)
    x, eps, noise = (rng.normal(size=(3, 4, 5)).astype(np.float32)
                     for _ in range(3))
    for ancestral in (True, False):
        js.ancestral = ps.ancestral = ancestral
        for i in range(len(pt)):
            s, sn = psig[i], psig[i + 1]
            got = ps.step(torch.from_numpy(eps), s, sn, torch.from_numpy(x),
                          torch.from_numpy(noise)).numpy()
            want = np.asarray(js.step(jnp.asarray(eps), jsig[i], jsig[i + 1],
                                      jnp.asarray(x), jnp.asarray(noise)))
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        ps.scale_model_input(torch.from_numpy(x), psig[0]).numpy(),
        np.asarray(js.scale_model_input(jnp.asarray(x), jsig[0])),
        atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        ps.add_noise(torch.from_numpy(x), torch.from_numpy(noise),
                     psig[0]).numpy(),
        np.asarray(js.add_noise(jnp.asarray(x), jnp.asarray(noise), jsig[0])),
        atol=1e-6, rtol=1e-6)


# ——— gen/unet.py and gen/vae.py at tiny widths ———

B, LAT = 2, 8


@pytest.fixture(scope="module")
def unet_case():
    cfg = junet.SDXLUNetConfig.tiny()
    jm = junet.SDXLUNet(cfg)
    tree = _random_tree(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, LAT, LAT, 4)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 4, 64)), None, None,
        jnp.zeros((1, 64))), 1)
    pm = punet.SDXLUNet(punet.SDXLUNetConfig.tiny())
    pm.load_state_dict(_part(params_from_flax({"unet": tree}), "unet"),
                       strict=True)
    return jm, tree, pm


@pytest.mark.parametrize("conditioned", [False, True])
def test_unet_matches_jax(unet_case, conditioned):
    jm, tree, pm = unet_case
    rng = np.random.default_rng(3)
    lat = rng.normal(size=(B, LAT, LAT, 4)).astype(np.float32)
    t = np.asarray([999, 3], np.int32)
    ctx = rng.normal(size=(B, 4, 64)).astype(np.float32)
    pooled = rng.normal(size=(B, 64)).astype(np.float32) if conditioned \
        else None
    tids = (np.tile(np.float32([[1024, 1024, 0, 0, 1024, 1024]]), (B, 1))
            if conditioned else None)
    emb = rng.normal(size=(B, 64)).astype(np.float32) if conditioned \
        else None
    want = np.asarray(jax.jit(lambda *a: jm.apply({"params": tree}, *a))(
        lat, t, ctx, pooled, tids, emb))

    def th(a):
        return None if a is None else torch.from_numpy(a)

    with torch.no_grad():
        got = _nhwc(pm(_nchw(lat), torch.from_numpy(t).long(), th(ctx),
                       th(pooled), th(tids), th(emb)))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-4 * scale, \
        np.abs(got - want).max() / scale


def test_generator_tree_round_trips(unet_case):
    """params_from_flax → flax_from_params gives the JAX tree back, bit for
    bit (the port writes the JAX generator's pickle)."""
    _, tree, _ = unet_case
    back = flax_from_params(params_from_flax({"unet": tree}))["unet"]
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


VAE_CFGS = {"tiny": {}, "mid_attention": {"use_mid_attention": True}}


@pytest.mark.parametrize("name", sorted(VAE_CFGS))
def test_vae_matches_jax(name):
    jcfg = dataclasses.replace(jvae.VAEConfig.tiny(), **VAE_CFGS[name])
    jv = jvae.VAE(jcfg)
    rng = np.random.default_rng(4)
    img = rng.uniform(-1, 1, size=(B, 16, 16, 3)).astype(np.float32)
    tree = _random_tree(lambda: jv.init(jax.random.key(0), jnp.asarray(img)),
                        5)
    pv = pvae.VAE(dataclasses.replace(pvae.VAEConfig.tiny(),
                                      **VAE_CFGS[name]))
    pv.load_state_dict(_part(params_from_flax({"vae": tree}), "vae"),
                       strict=True)
    enc = jax.jit(lambda x: jv.apply({"params": tree}, x,
                                     method=jvae.VAE.encode))(img)
    dec = jax.jit(lambda z: jv.apply({"params": tree}, z,
                                     method=jvae.VAE.decode))(enc)
    with torch.no_grad():
        got_enc = _nhwc(pv.encode(_nchw(img)))
        got_dec = _nhwc(pv.decode(_nchw(enc)))
    for got, want in ((got_enc, enc), (got_dec, dec)):
        want = np.asarray(want)
        assert np.abs(got - want).max() <= 1e-4 * max(np.abs(want).max(), 1)


# ——— gen/sdxl.py ———


@pytest.fixture(scope="module")
def generator_case():
    gcfg = jsdxl.GeneratorConfig.tiny()
    jgen = jsdxl.Generator4Embeds(gcfg, dtype=jnp.float32)
    h, w = gcfg.latent_size
    f = gcfg.pixel_factor

    def init():
        return {"params": {
            "unet": jgen.unet.init(
                jax.random.key(0), jnp.zeros((1, h, w, 4)),
                jnp.zeros((1,), jnp.int32), jnp.zeros((1, 4, 64)), None,
                None, jnp.zeros((1, 64)))["params"],
            "vae": jgen.vae.init(jax.random.key(1),
                                 jnp.zeros((1, h * f, w * f, 3)))["params"]}}

    tree = _random_tree(init, 6)
    jgen.load_params(tree)
    pgen = psdxl.Generator4Embeds(psdxl.GeneratorConfig.tiny(),
                                  dtype=torch.float32, device="cpu")
    pgen.load_params(tree)
    return jgen, pgen


#: guidance 0 from noise, and guidance 3 from img2img init latents
GEN_CASES = {"guidance_0": {},
             "guidance_3_img2img": {"guidance_scale": 3.0,
                                    "img2img_strength": 0.5}}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_generate_matches_jax_on_shared_noise(generator_case, case):
    jgen, pgen = generator_case
    kw = GEN_CASES[case]
    rng = np.random.default_rng(7)
    emb = rng.normal(size=(B, 64)).astype(np.float32)
    ctx = rng.normal(size=(B, 4, 64)).astype(np.float32)
    pooled = rng.normal(size=(B, 64)).astype(np.float32)
    init = None
    if "img2img_strength" in kw:
        init = (0.5 * rng.normal(size=(B, LAT, LAT, 4))).astype(np.float32)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(11), i))(
        jnp.arange(B))
    want = np.asarray(jgen.generate(
        jnp.asarray(emb), text_context=jnp.asarray(ctx),
        pooled_text_embed=jnp.asarray(pooled), row_keys=keys,
        init_latents=None if init is None else jnp.asarray(init), **kw))
    steps = 2 if init is not None else 4  # round(4 · 0.5) steps kept
    noises = [_nchw(jddpm.row_noise(keys, s, (LAT, LAT, 4)))
              for s in range(steps + 1)]
    got = pgen.generate(
        emb, text_context=ctx, pooled_text_embed=pooled,
        init_latents=None if init is None else _nchw(init),
        init_noise=noises[0], step_noises=torch.stack(noises[1:]), **kw)
    assert got.shape == want.shape == (B, 16, 16, 3)
    assert np.abs(got.numpy() - want).max() <= 1e-4


def test_encode_init_image_matches_jax(generator_case):
    """Pixels in [0, 1] → the img2img init latents (the VAE mean × scale),
    NHWC in, NCHW out."""
    jgen, pgen = generator_case
    imgs = np.random.default_rng(12).uniform(size=(B, 16, 16, 3)).astype(
        np.float32)
    want = np.asarray(jsdxl.encode_init_image(jgen, jgen.params,
                                              jnp.asarray(imgs)))
    got = _nhwc(psdxl.encode_init_image(pgen, imgs))
    assert got.shape == want.shape == (B, LAT, LAT, 4)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_init_random_fills_on_the_device_in_its_dtype():
    """``init_random`` materialises the meta-built modules: the products'
    weights in the working dtype, the norms' in fp32, N(0, 0.02) from the
    seed, reproducibly; without ``device="cpu"`` the generator raises on a
    host without CUDA."""
    cfg = psdxl.GeneratorConfig.tiny()
    a = psdxl.Generator4Embeds(cfg, dtype=torch.bfloat16, device="cpu")
    a.init_random(seed=3)
    b = psdxl.Generator4Embeds(cfg, dtype=torch.bfloat16, device="cpu")
    b.init_random(seed=3)
    sd = a.net.state_dict()
    assert all(v.device.type == "cpu" for v in sd.values())
    assert sd["unet.conv_in.weight"].dtype == torch.bfloat16
    assert sd["unet.conv_norm_out.weight"].dtype == torch.float32
    assert all(torch.equal(v, b.net.state_dict()[k]) for k, v in sd.items())
    w = torch.cat([v.float().flatten() for v in sd.values()])
    assert abs(float(w.std()) - 0.02) < 1e-3
    out = a.generate(np.zeros((1, 64), np.float32), row_keys=torch.tensor([5]))
    assert out.shape == (1, 16, 16, 3) and bool(torch.isfinite(out).all())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            psdxl.Generator4Embeds(cfg)


# ——— gen/text_encoder.py ———


def _hf_clip_text_sd(rng, cfg, projection):
    """A random transformers-layout CLIP text state dict."""
    w, t = cfg.width, "text_model"

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32) / np.sqrt(shape[-1])

    sd = {f"{t}.embeddings.token_embedding.weight": r(cfg.vocab_size, w),
          f"{t}.embeddings.position_embedding.weight": r(cfg.context_length,
                                                         w),
          f"{t}.final_layer_norm.weight": 1 + r(w),
          f"{t}.final_layer_norm.bias": r(w)}
    for i in range(cfg.layers):
        p = f"{t}.encoder.layers.{i}"
        for n in ("q", "k", "v", "out"):
            sd[f"{p}.self_attn.{n}_proj.weight"] = r(w, w)
            sd[f"{p}.self_attn.{n}_proj.bias"] = r(w)
        for n in ("layer_norm1", "layer_norm2"):
            sd[f"{p}.{n}.weight"] = 1 + r(w)
            sd[f"{p}.{n}.bias"] = r(w)
        sd[f"{p}.mlp.fc1.weight"], sd[f"{p}.mlp.fc1.bias"] = r(4 * w, w), r(
            4 * w)
        sd[f"{p}.mlp.fc2.weight"], sd[f"{p}.mlp.fc2.bias"] = r(w, 4 * w), r(w)
    if projection:
        sd["text_projection.weight"] = r(cfg.embed_dim, w)
    return sd


def test_text_encoder_matches_jax():
    from eeg_image_decode_tpu.models.clip_vit import CLIPTextConfig as JCfg
    from eeg_image_decode_tpu_torch.models.clip_vit import CLIPTextConfig

    jcfg = jte.SDXLTextEncoderConfig(
        clip_l=JCfg.tiny(act="quick_gelu"),
        big_g=dataclasses.replace(JCfg.tiny(act="gelu"), embed_dim=48))
    pcfg = pte.SDXLTextEncoderConfig(
        clip_l=CLIPTextConfig.tiny("quick_gelu"),
        big_g=dataclasses.replace(CLIPTextConfig.tiny("gelu"), embed_dim=48))
    rng = np.random.default_rng(8)
    sd1 = _hf_clip_text_sd(rng, pcfg.clip_l, projection=False)
    sd2 = _hf_clip_text_sd(rng, pcfg.big_g, projection=True)
    # the transformers-layout converters, bit for bit
    jtree = jte.convert_sdxl_text_encoders(sd1, sd2, jcfg)
    pst = pte.convert_sdxl_text_encoders(sd1, sd2, pcfg)
    penc = pte.SDXLTextEncoder(pcfg, device="cpu")
    penc.load_flax_params(jax.tree_util.tree_map(np.asarray, jtree))
    for name, tower in (("te1", penc.tower1), ("te2", penc.tower2)):
        got = tower.state_dict()
        assert set(got) == set(pst[name])
        for k, v in pst[name].items():
            assert torch.equal(v, got[k]), k

    ids = rng.integers(1, 60, size=(3, 12)).astype(np.int32)
    ids[:, 7] = 63  # EOT (the largest id) inside the row
    ids2 = ids.copy()
    ids2[:, 8:] = 5  # tower 2's pad token differs
    jenc = jte.SDXLTextEncoder(jcfg)
    want_ctx, want_pooled = jenc.encode_tokens(jtree, jnp.asarray(ids),
                                               jnp.asarray(ids2))
    ctx, pooled = penc.encode_tokens(ids, ids2)
    assert ctx.shape == (3, 12, 64) and pooled.shape == (3, 48)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(want_ctx), atol=1e-5)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled),
                               atol=1e-5)


# ——— gen/convert.py ———


def _diffusers_dicts(rng, cfg, ip_order=None):
    """A random diffusers-keyed UNet state dict at the port UNet's keys and
    an IP-Adapter dict (odd ``ip_adapter`` indices, in ``ip_order`` of the
    cross-attentions, default the checkpoint's own)."""
    with torch.device("meta"):
        unet = punet.SDXLUNet(cfg)
    names = {id(m): n for n, m in unet.named_modules()}
    sd, ip = {}, {}
    for k, v in unet.state_dict().items():
        a = rng.normal(size=tuple(v.shape)).astype(np.float32)
        if k.startswith("image_proj."):
            ip[k] = a
        elif "_ip." not in k:
            sd[k] = a
    attn2 = [names[id(m)] for m in unet.cross_attentions()]
    order = ip_order(attn2) if ip_order else attn2
    for i, name in enumerate(order):
        for kv in ("k", "v"):
            shape = tuple(unet.get_submodule(name).to_k.weight.shape)
            ip[f"ip_adapter.{2 * i + 1}.to_{kv}_ip.weight"] = rng.normal(
                size=shape).astype(np.float32)
    return sd, ip


def test_convert_matches_jax_bit_for_bit():
    rng = np.random.default_rng(9)
    sd, ip = _diffusers_dicts(rng, punet.SDXLUNetConfig.tiny())
    got = pconvert.convert_sdxl_unet(sd, punet.SDXLUNetConfig.tiny(), ip)
    want = _part(params_from_flax({"unet": jconvert.convert_sdxl_unet(
        sd, junet.SDXLUNetConfig.tiny(), ip)}), "unet")
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    punet.SDXLUNet(punet.SDXLUNetConfig.tiny()).load_state_dict(got,
                                                                strict=True)

    cfg = dataclasses.replace(pvae.VAEConfig.tiny(), use_mid_attention=True)
    with torch.device("meta"):
        vae = pvae.VAE(cfg)
    vsd = {k: rng.normal(size=tuple(v.shape)).astype(np.float32)
           for k, v in vae.state_dict().items()}
    got = pconvert.convert_sdxl_vae(vsd, cfg)
    want = _part(params_from_flax({"vae": jconvert.convert_sdxl_vae(
        vsd, dataclasses.replace(jvae.VAEConfig.tiny(),
                                 use_mid_attention=True))}), "vae")
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_convert_refuses_a_misordered_ip_adapter():
    """Two attention widths (32 and 64 channels): an IP-Adapter dict in
    spatial order (down, mid, up) instead of registration order (down, up,
    mid) puts a 64-wide entry on a 32-wide cross-attention; both packages
    raise, and a missing key raises too."""
    kw = dict(block_out_channels=(16, 32, 64), layers_per_block=1,
              transformer_layers_per_block=(0, 1, 1), attention_head_dim=16,
              cross_attention_dim=64, addition_time_embed_dim=32,
              pooled_text_embed_dim=64, norm_groups=8, ip_image_embed_dim=64,
              ip_num_tokens=2)
    pcfg, jcfg = punet.SDXLUNetConfig(**kw), junet.SDXLUNetConfig(**kw)

    def spatial(names):
        return ([n for n in names if n.startswith("down")]
                + [n for n in names if n.startswith("mid")]
                + [n for n in names if n.startswith("up")])

    sd, ip = _diffusers_dicts(np.random.default_rng(10), pcfg, spatial)
    with pytest.raises(ValueError, match="enumeration-order mismatch"):
        pconvert.convert_sdxl_unet(sd, pcfg, ip)
    with pytest.raises(ValueError, match="enumeration-order mismatch"):
        jconvert.convert_sdxl_unet(sd, jcfg, ip)
    sd_ok, ip_ok = _diffusers_dicts(np.random.default_rng(10), pcfg)
    pconvert.convert_sdxl_unet(sd_ok, pcfg, ip_ok)  # the right order loads
    del sd_ok["conv_in.weight"]
    with pytest.raises(KeyError, match="conv_in.weight"):
        pconvert.convert_sdxl_unet(sd_ok, pcfg, ip_ok)


# ——— full width, no memory ———


def test_full_width_structure_matches_jax():
    """The ``sdxl_turbo()`` UNet with the IP-Adapter and the ``sdxl()`` VAE
    built on ``meta`` hold exactly the JAX trees' parameters, name for name
    and shape for shape, through the generator map of ``params_from_flax``
    (applied to zero-stride views: no memory)."""
    jgen = jsdxl.Generator4Embeds(jsdxl.GeneratorConfig(), dtype=jnp.float32)

    def init():
        return {
            "unet": jgen.unet.init(
                jax.random.key(0), jnp.zeros((1, 64, 64, 4)),
                jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 2048)), None,
                None, jnp.zeros((1, 1024)))["params"],
            "vae": jgen.vae.init(jax.random.key(1),
                                 jnp.zeros((1, 512, 512, 3)))["params"]}

    shapes = jax.eval_shape(init)
    views = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    want = {k: tuple(v.shape)
            for k, v in generator_arrays_from_flax(views).items()}
    with torch.device("meta"):
        net = torch.nn.ModuleDict({
            "unet": punet.SDXLUNet(punet.SDXLUNetConfig.sdxl_turbo(),
                                   dtype=torch.bfloat16),
            "vae": pvae.VAE(pvae.VAEConfig.sdxl(), dtype=torch.bfloat16)})
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert got == want
    n_unet = sum(np.prod(s) for k, s in got.items() if k.startswith("unet."))
    n_vae = sum(np.prod(s) for k, s in got.items() if k.startswith("vae."))
    n_ip = sum(np.prod(s) for k, s in got.items()
               if "_ip." in k or "image_proj." in k)
    # SDXL's UNet holds 2.567 B parameters; the IP-Adapter's K/V of its 70
    # cross-attentions and its image projection add 0.350 B
    assert 2.56e9 < n_unet - n_ip < 2.58e9 and 3.4e8 < n_ip < 3.6e8 \
        and 8.0e7 < n_vae < 8.5e7, (n_unet, n_ip, n_vae)
