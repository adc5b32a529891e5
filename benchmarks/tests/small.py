"""The cells at sizes a CPU test run holds: the published widths of ATM-S
at a small split and batch, and SDXL's, the prior's and the encoder's head
cut to the port's tiny generator."""

from __future__ import annotations

import copy

from benchmarks.harness import spec


def training_cell(name: str = "atms_train_resident", *, classes: int = 16,
                  batch: int = 32) -> spec.Cell:
    cell = spec.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["data"].update(n_classes=classes, n_test_classes=8)
    cell.config["train"]["batch_size"] = batch
    return cell


def recon_cell() -> spec.Cell:
    cell = spec.load_cell("recon_poisson_rows1")
    c = copy.deepcopy(cell.config)
    c["unet"].update(block_out_channels=[32, 64], layers_per_block=1,
                     transformer_layers_per_block=[0, 1],
                     attention_head_dim=16, cross_attention_dim=64,
                     addition_time_embed_dim=32, pooled_text_embed_dim=64,
                     norm_groups=8, ip_image_embed_dim=64, ip_num_tokens=2)
    c["vae"].update(block_out_channels=[16, 32], layers_per_block=1,
                    norm_groups=4, use_mid_attention=False)
    c["prior"].update(embed_dim=64, cond_dim=64, hidden_dims=[64, 32],
                      time_embed_dim=32, num_inference_steps=4)
    c["encoder"]["proj_dim"] = 64
    c["generation"].update(latent_size=[8, 8], text_len=4)
    c["max_batch"] = 4
    cell.config = c
    cell.mix = dict(cell.mix, rate_per_s=4.0, sample_requests=4,
                    trace_before_close_s=0.2, trace_seconds=0.5)
    return cell
