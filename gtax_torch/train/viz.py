"""Debug visualisation grid (copy of gtax/train/viz.py, the reference's
visualize_step): a 5-row matplotlib figure (original / noisy / noise /
v-pred / denoised) with latents decoded through the VAE, written to
debug_visualizations/. matplotlib is imported only when it is called."""

from __future__ import annotations

import os

import numpy as np


def visualize_step(x_curr, x_noisy, noise, v, pred, step: int, decode_fn,
                   name: str | None = None,
                   out_dir: str = "debug_visualizations"):
    """All latent args are (1, T, C, h, w) numpy; decode_fn maps latents to
    uint8 video (1, T, H, W, 3). Returns the png's path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    T = x_curr.shape[1]
    fig, axes = plt.subplots(5, T, figsize=(4 * T, 20), squeeze=False)
    orig = decode_fn(x_curr)[0]
    noisy = decode_fn(x_noisy)[0]
    den = decode_fn(pred)[0]
    for t in range(T):
        axes[0][t].imshow(orig[t])
        axes[0][t].set_title(f"Original {t}\n[{x_curr[0, t].min():.2f}, "
                             f"{x_curr[0, t].max():.2f}]")
        axes[1][t].imshow(noisy[t])
        axes[1][t].set_title(f"Noisy {t}\n[{x_noisy[0, t].min():.2f}, "
                             f"{x_noisy[0, t].max():.2f}]")
        im = axes[2][t].imshow(np.asarray(noise[0, t]).mean(axis=0),
                               cmap="RdBu", interpolation="nearest")
        plt.colorbar(im, ax=axes[2][t])
        axes[2][t].set_title(f"Noise {t}")
        im = axes[3][t].imshow(np.asarray(v[0, t]).mean(axis=0), cmap="RdBu",
                               interpolation="nearest")
        plt.colorbar(im, ax=axes[3][t])
        axes[3][t].set_title(f"v-pred {t}")
        axes[4][t].imshow(den[t])
        axes[4][t].set_title(f"Denoised {t}")
        for r in range(5):
            axes[r][t].axis("off")
    fig.suptitle(f"Step {step}", y=1.0, fontsize=16)
    fig.tight_layout()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name or f"sequence_step_{step}.png")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path
