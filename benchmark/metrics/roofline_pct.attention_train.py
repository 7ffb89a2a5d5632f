"""roofline_pct.attention_train: the training attention kernels'
(``csrc/attention_train.cu``: the forward, dQ and dK/dV grids, which
serve the packed, strided and merged layouts) share of their roofline
over the traced window: the least time the card could take for the calls
the window made (``costs.attention_costs`` at each call's shape) over the
device time of the kernels named in KERNELS.

The calls the step's shapes need: each HuBERT layer layerdrop kept, where
HuBERT's attention runs a training kernel, and each ViT layer of each
image batch, where the ViT's does. Where the launch counts differ from
that (the op runs elsewhere), the metric reports nothing. Moves
samples_per_s."""

import costs

KERNELS = ("attention_train_fwd_kernel", "attention_train_dq_kernel",
           "attention_train_dkv_kernel")
WRAPPERS = ("attention_train", "attention_train_strided", "attention_train_merged")
TRAIN_IMPLS = ("fused", "fused_packed", "fused_packed_merged")


def _calls(run):
    """[(calls, batch, tokens)] of the window's forward calls."""
    cfg, tr = run.config, run.traffic
    h, v = cfg["hubert"], cfg["vit"]
    out = []
    if h["attention_impl"] in TRAIN_IMPLS + ("auto",) and h["attention_dropout"] > 0:
        n = costs.frontend_tokens(h, tr["audio_samples"])[-1]
        out.append((sum(len(k) for k in run.kept), tr["batch_av"], n))
    if v["attention_impl"] in TRAIN_IMPLS:
        n = 1 + v["num_register_tokens"] + (v["image_size"] // v["patch_size"]) ** 2
        for b in (tr["batch_av"], tr["batch_tv"]):
            out.append((run.steps * v["num_layers"], b, n))
    return out


def read(run):
    calls = _calls(run)
    want = sum(c for c, _, _ in calls)
    fwd = sum(run.launches.get(w, 0) for w in WRAPPERS)
    bwd = sum(run.launches.get(w + "_bwd", 0) for w in WRAPPERS)
    if want == 0 or fwd != want or bwd != want:
        run.log(f"roofline_pct.attention_train: launches forward {fwd}, backward {bwd}; the "
                f"step's shapes need {want} each: not read")
        return None
    least_ms = 0.0
    for count, b, n in calls:
        (f_ms, _), (b_ms, _) = costs.attention_costs(b, n)
        least_ms += count * (f_ms + b_ms)
    took = run.digest.seconds(KERNELS, case=True)
    if took <= 0:
        return None
    return 100.0 * least_ms * 1e-3 / took
