"""roofline_pct.fused_mlp: the fused MLP kernels' (``csrc/fused_mlp.cu``,
forward and backward GEMM grids) share of their roofline over the traced
window: the least time for the calls the window made
(``costs.mlp_fwd_cost`` and ``costs.mlp_bwd_cost`` at each call's rows)
over the device time of the kernels named in KERNELS.

The calls the step's shapes need: each HuBERT layer layerdrop kept, where
HuBERT's MLP is fused ("auto" takes the kernel on the card), and each ViT
layer of each image batch, where the ViT's MLP is fused. Where the launch
counts differ from that, the metric reports nothing. Moves
samples_per_s."""

import costs

KERNELS = ("mlp_gemm_kernel",)


def _calls(run):
    """[(calls, rows)] of the window's forward calls."""
    cfg, tr = run.config, run.traffic
    h, v = cfg["hubert"], cfg["vit"]
    out = []
    if h["mlp_impl"] in ("auto", "fused"):
        n = costs.frontend_tokens(h, tr["audio_samples"])[-1]
        out.append((sum(len(k) for k in run.kept), tr["batch_av"] * n))
    if v["mlp_impl"] == "fused":
        n = 1 + v["num_register_tokens"] + (v["image_size"] // v["patch_size"]) ** 2
        for b in (tr["batch_av"], tr["batch_tv"]):
            out.append((run.steps * v["num_layers"], b * n))
    return out


def read(run):
    calls = _calls(run)
    want = sum(c for c, _ in calls)
    fwd, bwd = run.launches.get("fused_mlp", 0), run.launches.get("fused_mlp_bwd", 0)
    if want == 0 or fwd != want or bwd != want:
        run.log(f"roofline_pct.fused_mlp: launches forward {fwd}, backward {bwd}; the step's "
                f"shapes need {want} each: not read")
        return None
    least_ms = sum(count * (costs.mlp_fwd_cost(m)[0] + costs.mlp_bwd_cost(m)[0])
                   for count, m in calls)
    took = run.digest.seconds(KERNELS, case=True)
    if took <= 0:
        return None
    return 100.0 * least_ms * 1e-3 / took
