"""diffusers SDXL checkpoints into the port's generator (counterpart of
``eeg_image_decode_tpu/gen/convert.py``).

The port's UNet and VAE carry diffusers' names (``gen/unet.py``,
``gen/vae.py``), so a ``UNet2DConditionModel`` / ``AutoencoderKL`` state
dict (``{name: array}``, read from safetensors with any reader) maps onto
them key for key; every key is shape-checked against the module built from
the config, and a missing one raises. The IP-Adapter file
(``ip-adapter_sdxl_vit-h``) adds ``image_proj.{proj,norm}`` and
``ip_adapter.{idx}.to_{k,v}_ip.weight``, indexed by the saved
``ModuleList(unet.attn_processors.values())`` position: attn1 processors
carry no parameters, so the surviving indices are the odd ones (1, 3, …,
139 for SDXL), in module registration order — ``down_blocks``,
``up_blocks``, then ``mid_block``. The entries are consumed sorted by index
and assigned in that order (``SDXLUNet.cross_attentions``); each entry's
shape is checked against its target cross-attention, so a mis-ordered
checkpoint fails loudly instead of loading one stage's weights into
another.
"""

from __future__ import annotations

import numpy as np
import torch

from eeg_image_decode_tpu_torch.gen.unet import SDXLUNet, SDXLUNetConfig
from eeg_image_decode_tpu_torch.gen.vae import VAE, VAEConfig


def _tensor(a) -> torch.Tensor:
    if torch.is_tensor(a):
        # a checkpoint on ``meta`` (names and shapes only) converts on meta
        return a.detach().to("meta" if a.is_meta else "cpu", torch.float32,
                             copy=True)
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _take(sd: dict, module: torch.nn.Module, skip=()) -> dict:
    """Every parameter of ``module`` (built on ``meta``) from ``sd`` by
    name, shape-checked; names containing one of ``skip`` are left out."""
    out = {}
    for name, p in module.state_dict().items():
        if any(s in name for s in skip):
            continue
        if name not in sd:
            raise KeyError(f"{name} is missing from the checkpoint")
        a = _tensor(sd[name])
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(a.shape)} in the "
                             f"checkpoint, {tuple(p.shape)} in the model")
        out[name] = a
    return out


def convert_sdxl_unet(sd: dict, cfg: SDXLUNetConfig = SDXLUNetConfig(),
                      ip_adapter_sd: dict | None = None
                      ) -> dict[str, torch.Tensor]:
    """``UNet2DConditionModel`` state dict (+ the optional IP-Adapter dict)
    → the port UNet's ``state_dict`` (fp32). With the IP-Adapter dict the
    result loads with ``load_state_dict(strict=True)``."""
    with torch.device("meta"):
        unet = SDXLUNet(cfg)
    out = _take(sd, unet, skip=("image_proj.", "_ip."))
    if ip_adapter_sd is None:
        return out
    names = {id(m): n for n, m in unet.named_modules()}
    blocks = [(names[id(m)], m) for m in unet.cross_attentions()]
    idxs = sorted({int(k.split(".")[1]) for k in ip_adapter_sd
                   if k.startswith("ip_adapter.")})
    if len(idxs) != len(blocks):
        raise ValueError(
            f"IP-Adapter checkpoint has {len(idxs)} cross-attn entries but "
            f"the UNet config defines {len(blocks)} cross-attentions")
    for i, (name, attn) in zip(idxs, blocks):
        want = tuple(attn.to_k.weight.shape)
        for kv in ("k", "v"):
            w = _tensor(ip_adapter_sd[f"ip_adapter.{i}.to_{kv}_ip.weight"])
            if tuple(w.shape) != want:
                raise ValueError(
                    f"IP-Adapter entry {i}: to_{kv}_ip shape "
                    f"{tuple(w.shape)} does not match its cross-attention "
                    f"{name} {want}: checkpoint/config enumeration-order "
                    f"mismatch")
            out[f"{name}.to_{kv}_ip.weight"] = w
    # image projection head: Linear (embed → tokens·dim) + LayerNorm
    head = {k[len("image_proj."):]: v for k, v in ip_adapter_sd.items()
            if k.startswith("image_proj.")}
    out.update({f"image_proj.{k}": v
                for k, v in _take(head, unet.image_proj).items()})
    return out


def convert_sdxl_vae(sd: dict, cfg: VAEConfig = VAEConfig()
                     ) -> dict[str, torch.Tensor]:
    """``AutoencoderKL`` state dict → the port VAE's ``state_dict`` (fp32,
    encoder + decoder + quant convs); loads with ``strict=True``."""
    with torch.device("meta"):
        vae = VAE(cfg)
    return _take(sd, vae)
