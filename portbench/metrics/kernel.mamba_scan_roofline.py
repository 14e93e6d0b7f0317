"""The selective-scan kernel's share of its roofline: the least time the
profiled window's scans need over the device time of the kernel's
records there.  The work is counted from the configuration and the
traffic, never from launch arguments: per Mamba layer and forward, B (S
- 1) Di channel-steps, each reading dt (float32) and x and z (the
model's bfloat16) once and writing y once, 4 + 2 + 2 + 2 bytes, and B
and C, St float32 each a step: the fused minimum, whatever the
implementation moves, at the card's HBM rate.  Two forwards a step
(two-point SPSA).  None where no record of the kernel was found (a
program without it)."""

LAYER = "kernels (kernels.zo_axpy K1, fused.matmul K3/K4)"
UNIT = "%"
BETTER = "higher"
MOVES = "train_tokens_per_s"
KERNELS = ("mamba_scan_kernel",)
FORWARDS = 2
BYTES_PER_CHANNEL_STEP = 4 + 2 + 2 + 2


def scan_bytes(cfg, traffic) -> float:
    """Bytes of one forward's scans over every Mamba layer."""
    layers = cfg["num_hidden_layers"]
    attn = sum(i % cfg["attn_layer_period"] == cfg["attn_layer_offset"]
               for i in range(layers))
    rows = traffic["batch"] * (traffic["seq_len"] - 1)
    Di = cfg["mamba_expand"] * cfg["hidden_size"]
    per_layer = rows * (Di * BYTES_PER_CHANNEL_STEP
                        + 2 * cfg["mamba_d_state"] * 4)
    return float((layers - attn) * per_layer)


def read(r):
    sec = sum(s for name, (s, _) in r.window["by_name"].items()
              if any(k in name for k in KERNELS))
    if sec <= 0 or "mamba_d_state" not in r.config:
        return None
    nbytes = r.window["steps"] * FORWARDS * scan_bytes(r.config, r.traffic)
    return 100.0 * nbytes / r.peak["hbm_bytes_per_s"] / sec
