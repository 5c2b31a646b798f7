"""The plain reference of what the timed paths produce: an enhanced clip
(PCM16 in and out, as the HTTP server and the offline batches run it) and
the first train steps of the recipe (featurize, the forward in train mode,
the loss, the gradients, the clip and AdamW)."""

from __future__ import annotations

import numpy as np
import torch

from . import hvit


def _pcm16_in(clip: np.ndarray) -> np.ndarray:
    """A PCM16 clip as the enhancer stages it: read as x / 32768, then
    ``int16(clip(x, -1, 1) * 32767)``, truncated toward zero."""
    x = clip.astype(np.float32) / 32768.0
    return (np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16)


@torch.no_grad()
def enhance_rows(p: dict, config: dict, clips: list, padded_len: int, device) -> list:
    """Enhance PCM16 ``clips`` padded together to ``padded_len`` samples:
    peak normalize, STFT, max normalize, the model with the padding masked,
    the mask on the noisy magnitude, the noisy-phase iSTFT, PCM16 out.
    Returns each clip's float32 output (PCM16 / 32767) at its own length."""
    audio, model_cfg = config["audio"], config["model"]
    hop = int(audio["hop_length"])
    batch = np.zeros((len(clips), padded_len), np.int16)
    for row, c in enumerate(clips):
        batch[row, : len(c)] = _pcm16_in(c)
    x = torch.from_numpy(batch).to(device).to(torch.float32) / 32768.0
    scale = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(scale > 1e-8, scale, torch.ones_like(scale))
    spec, mag = hvit.stft(x / scale, audio)
    phase = torch.angle(spec)
    mag_max = mag.amax(dim=(-2, -1), keepdim=True)
    mag_max = torch.where(mag_max > 1e-8, mag_max, torch.ones_like(mag_max))
    mask = None
    if config.get("mask_padding"):
        lengths = torch.tensor([len(c) for c in clips])
        mask = hvit.key_mask(model_cfg, mag.shape[-2], mag.shape[-1], hop, lengths).to(device)
    out = hvit.forward(p, model_cfg, (mag / mag_max)[..., None], mask=mask)[..., 0]
    if model_cfg.get("output_mode", "magnitude") == "mask":
        est = torch.clamp((out + 1.0) * 0.5, 0.0, 1.0) * mag
    else:
        est = out * mag_max
    y = hvit.istft(est, phase, audio, padded_len) * scale
    y16 = (torch.clamp(y, -1.0, 1.0) * 32767.0).to(torch.int16).cpu().numpy()
    return [y16[row, : len(c)].astype(np.float32) / 32767.0 for row, c in enumerate(clips)]


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def is_parameter(name: str) -> bool:
    return not name.endswith(BUFFERS)


def _minmax(mag, frame_mask):
    m = frame_mask[:, None, :]
    mn = torch.where(m, mag, torch.inf).amin(dim=(1, 2))
    mx = torch.where(m, mag, -torch.inf).amax(dim=(1, 2))
    normed = (mag - mn[:, None, None]) / torch.clamp(mx - mn, min=1e-8)[:, None, None]
    return torch.where(m, normed, 0.0), mx


def loss(p: dict, config: dict, batch: dict, recipe: dict) -> torch.Tensor:
    """The recipe's loss of one batch in train mode: min-max normalized noisy
    magnitude in, a [0, 1] mask on the noisy magnitude out, against the clean
    magnitude (both over the noisy max): L1 + log-L1 + the STOI proxy (one
    minus the cosine of each row's flattened spectrograms), over valid rows."""
    audio, model_cfg = config["audio"], config["model"]
    hop = int(audio["hop_length"])
    noisy = batch["noisy_audio"].to(torch.float32) / 32768.0
    clean = batch["clean_audio"].to(torch.float32) / 32768.0
    _, noisy_mag = hvit.stft(noisy, audio)
    _, clean_mag = hvit.stft(clean, audio)
    t = noisy_mag.shape[-1]
    n_valid = 1 + batch["length"].to(torch.int64) // hop
    frame_mask = torch.arange(t, device=noisy.device)[None, :] < n_valid[:, None]
    model_in, n_max = _minmax(noisy_mag, frame_mask)
    mask = None
    if config.get("mask_padding"):
        mask = hvit.key_mask(model_cfg, noisy_mag.shape[-2], t, hop, batch["length"].cpu())
        mask = mask.to(noisy.device)
    out = hvit.forward(p, model_cfg, model_in[..., None], mask=mask, train=True)[..., 0]
    inv = 1.0 / torch.clamp(n_max, min=1e-8)[:, None, None]
    pred = (out + 1.0) * 0.5 * (noisy_mag * inv)
    target = clean_mag * inv
    valid = batch["valid"].to(torch.float32)
    rows = valid[:, None, None]
    count = torch.clamp(valid.sum() * pred.shape[1] * pred.shape[2], min=1.0)
    l1 = (torch.abs(pred - target) * rows).sum() / count
    eps = recipe["log_eps"]
    log_l1 = (torch.abs(torch.log(pred.abs() + eps) - torch.log(target.abs() + eps))
              * rows).sum() / count
    pf, tf = pred.reshape(len(pred), -1), target.reshape(len(target), -1)
    cos = (pf * tf).sum(1) / (torch.clamp(pf.norm(dim=1), min=1e-12)
                              * torch.clamp(tf.norm(dim=1), min=1e-12))
    stoi = ((1.0 - cos) * valid).sum() / torch.clamp(valid.sum(), min=1.0)
    return (recipe["l1_weight"] * l1 + recipe["log_l1_weight"] * log_l1
            + recipe["stoi_weight"] * stoi)


def train_steps(p: dict, config: dict, batches: list, recipe: dict) -> dict:
    """Follow the recipe's first ``len(batches)`` steps from the weights
    ``p`` (updated in place): per step the loss; per parameter the norm of
    the first step's clipped gradient and the norm of its change over all
    the steps. AdamW with optax's arithmetic; the clip by the global norm
    scales when the norm reaches ``max_norm``."""
    names = [n for n in p if is_parameter(n)]
    params = [p[n].requires_grad_(True) for n in names]
    b1, b2, eps = recipe["betas"][0], recipe["betas"][1], recipe["eps"]
    lr, wd, max_norm = recipe["lr"], recipe["weight_decay"], recipe["max_norm"]
    start = [q.detach().clone() for q in params]
    mu = [torch.zeros_like(q) for q in params]
    nu = [torch.zeros_like(q) for q in params]
    losses, first_grad = [], None
    for count, batch in enumerate(batches, start=1):
        total = loss(p, config, batch, recipe)
        grads = torch.autograd.grad(total, params)
        losses.append(float(total.detach()))
        with torch.no_grad():
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            if float(g_norm) >= max_norm:
                grads = [g / g_norm * max_norm for g in grads]
            if first_grad is None:
                first_grad = {n: float(g.norm()) for n, g in zip(names, grads)}
            c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
            for q, g, m, v in zip(params, grads, mu, nu):
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                q.sub_(lr * ((m / c1) / (torch.sqrt(v / c2) + eps) + wd * q))
    with torch.no_grad():
        change = {n: float((q - s).norm()) for n, q, s in zip(names, params, start)}
    return {"losses": losses, "grad_norms": first_grad, "change_norms": change}
