"""Training: the recipe's step (``training.trainer.make_step_fns``) on
padded PCM16 loader batches, staged to the card each step as the loader's
batches are (``batch_to_device``).

Parameters: ``lengths`` (clip lengths), ``batch`` (rows a step),
``bucket_frames`` (the frame bucket every batch is padded to), ``pool``
(distinct batches made from the seed; the window cycles them), ``recipe``
(the loss weights and AdamW's settings).

Set-up builds one step object (model, optimizer state) and drives it from
the seed's weights through its first three steps on three batches whose rows
all differ, through the window's own call and feed: those are what the
reference follows. The window then runs steps until its time is up; a traced
run then profiles further steps for ``trace.TRACE_SECONDS``.
"""

from __future__ import annotations

import time

import numpy as np

from .. import T_START, checks, clips, system, trace, weights, work

COMPARED_STEPS = 3


def make_batches(ctx) -> list:
    """Loader batches (numpy): PCM16 noisy and clean padded to the bucket,
    true lengths, every row valid."""
    p, hop = ctx.params, ctx.config["audio"]["hop_length"]
    n_rows = p["batch"] * p["pool"]
    pairs = clips.pair_pool(ctx.seed, clips.lengths_for(p, n_rows))
    wav_len = (p["bucket_frames"] - 1) * hop
    out = []
    for b in range(p["pool"]):
        rows = pairs[b * p["batch"]:(b + 1) * p["batch"]]
        noisy = np.zeros((len(rows), wav_len), np.int16)
        clean = np.zeros_like(noisy)
        for r, (n, c) in enumerate(rows):
            noisy[r, :len(n)] = n
            clean[r, :len(c)] = c
        out.append({"noisy_audio": noisy, "clean_audio": clean,
                    "length": np.array([len(n) for n, _ in rows], np.int32),
                    "valid": np.ones(len(rows), bool)})
    return out


def build_step(ctx, model):
    P = system.port
    recipe = ctx.params["recipe"]
    opt = P("training.optimizer").Optimizer(
        P("training.optimizer").parameters(model), "adamw", lr=recipe["lr"],
        betas=tuple(recipe["betas"]), eps=recipe["eps"], weight_decay=recipe["weight_decay"],
        max_norm=recipe["max_norm"])
    loss_cfg = P("training.losses").LossConfig(
        l1_weight=recipe["l1_weight"], stoi_weight=recipe["stoi_weight"],
        log_l1_weight=recipe["log_l1_weight"], log_eps=recipe["log_eps"])
    step, _ = P("training.trainer").make_step_fns(
        model, opt, loss_cfg, system.stft_config(ctx.config),
        P("data.augmentation").SpecAugmentConfig(), augment=False,
        use_attention_mask=bool(ctx.config["mask_padding"]),
        output_mode=ctx.config["model"]["output_mode"])
    return step, opt


def run(ctx) -> dict:
    p, config, dev = ctx.params, ctx.config, ctx.device
    span = ctx.spans.span
    system.use_precision(config)
    with span("inputs"):
        batches = make_batches(ctx)
    to_device = system.port("training.trainer").batch_to_device
    with span("build"):
        model, w = system.build_model(config, ctx.seed, dev)
        shapes = weights.float_shapes(model)
        del w
        step, opt = build_step(ctx, model)
    names = [n for n, _ in model.named_parameters()]
    b1 = opt.b1

    def one(i):
        with span("feed"):
            batch = to_device(batches[i % len(batches)], dev)
        with span("step"):
            return step(batch)

    # the compared steps: also the warm-up (one shape, built at the first)
    with span("warm"):
        start = {n: t.detach().to("cpu", copy=True) for n, t in model.named_parameters()}
        losses, grad_norms = [], None
        for i in range(COMPARED_STEPS):
            losses.append(float(one(i)["total"]))
            if i == 0:
                grad_norms = {n: float(m.norm()) / (1.0 - b1) for n, m in zip(names, opt.mu)}
        change = {n: float((t.detach().cpu() - start[n]).norm())
                  for n, t in model.named_parameters()}
        del start
    prog = {"losses": losses, "grad_norms": grad_norms, "change_norms": change}

    a = config["audio"]
    spec = work.spec_from_config(config["model"])
    wav_len = (p["bucket_frames"] - 1) * a["hop_length"]
    n_params = system.count_params(model)
    step_flops = work.train_step_flops(spec, p["batch"], a["n_fft"], a["hop_length"], wav_len,
                                       n_params)
    f_bins = a["n_fft"] // 2 + 1

    def attn_of(i):
        lens = batches[i % len(batches)]["length"].tolist()
        w = work.attention_work(spec, f_bins, p["bucket_frames"], a["hop_length"],
                                lens if config["mask_padding"] else None, p["batch"])
        return w["fwd"], w["bwd"]

    def drive(seconds, i, traced=None):
        """Steps from batch ``i`` until ``seconds`` have passed: ``(next i,
        steps, audio-seconds, steps skipped as non-finite)``."""
        t, n, audio, skipped = time.perf_counter(), 0, 0.0, 0.0
        while time.perf_counter() - t < seconds:
            skipped = skipped + one(i)["nonfinite_skipped"]
            if traced is not None:
                traced.append(i)
            audio += float(batches[i % len(batches)]["length"].sum()) / clips.SAMPLE_RATE
            i += 1
            n += 1
        return i, n, audio, int(float(skipped))

    t0 = time.perf_counter()
    setup_s = t0 - T_START
    i, n_steps, audio_s, skipped = drive(ctx.seconds, COMPARED_STEPS)
    t1 = time.perf_counter()
    window = t1 - t0
    ctx.facts.update(window_s=window, window_flops=step_flops * n_steps, t0=t0, t1=t1)
    if ctx.tracer.enabled:
        traced = []
        ctx.tracer.start()
        _, n_traced, _, _ = drive(trace.TRACE_SECONDS, i, traced)
        ctx.tracer.stop()
        ctx.facts.update(slice_flops=step_flops * n_traced,
                         slice_s=ctx.tracer.t1 - ctx.tracer.t0,
                         traced_attention=[attn_of(j) for j in traced])
    del step, opt, model
    compared = [batches[j] for j in range(COMPARED_STEPS)]

    def check():
        return checks.train_check(config, ctx.seed, dev, shapes, compared, p["recipe"], prog,
                                  ctx.control)

    return {"e2e": {"train_audio_s_per_s": audio_s / window, "setup_s": setup_s},
            "attempted": n_steps, "failed": skipped, "check": check}
