"""Training-summary plot (counterpart of
``eeg_image_decode_tpu/utils/plotting.py``): the reference's 6-panel figure
(``Retrieval/ATMS_retrieval.py:462-510`` → ``pos_img_text.png``): loss
curves, accuracy curves, k-way accuracies at 2/4/10, and a best-epoch info
box.

Drawn with matplotlib's object API on an Agg canvas, not through
``pyplot``: no backend switch and no global figure state.
"""

from __future__ import annotations

from typing import Sequence


def plot_training_summary(history: Sequence[dict], path: str) -> str:
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    epochs = [r.get("epoch", i) for i, r in enumerate(history)]

    def series(key):
        return ([r.get(key) for r in history]
                if any(key in r for r in history) else None)

    fig = Figure(figsize=(15, 8))
    FigureCanvasAgg(fig)
    axes = fig.subplots(2, 3)
    panels = [
        ("loss", "Train loss"),
        ("train_acc", "Train accuracy (n_cls-way probe)"),
        ("top1_k200", "Test top-1 (200-way)"),
        ("top1_k2", "2-way accuracy"),
        ("top1_k4", "4-way accuracy"),
        ("top1_k10", "10-way accuracy"),
    ]
    for ax, (key, title) in zip(axes.flat, panels):
        s = series(key)
        if s and any(v is not None for v in s):
            ax.plot(epochs, s, marker="o", markersize=2)
        ax.set_title(title)
        ax.set_xlabel("epoch")

    best = max(
        (r for r in history if "top1_k200" in r or "loss" in r),
        key=lambda r: r.get("top1_k200", -r.get("loss", 0.0)),
        default=None,
    )
    if best is not None:
        info = ", ".join(f"{k}={v:.4f}" for k, v in best.items()
                         if isinstance(v, float) and k != "time")
        fig.suptitle(f"best epoch {best.get('epoch', '?')}: {info}",
                     fontsize=9)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    return path
