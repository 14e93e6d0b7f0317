"""Model flops of the timed window's steps over its host seconds, as a
share of the card's bf16 peak: the whole step's share, which bounds
what a kernel's gain can add once the kernel is off the path.  Model
flops are 2 forwards x 2 N_active a token plus attention's causal
score and value products (``work.model_flops_per_step``; the tied head
counts, routed experts at top_k / n_experts)."""

LAYER = "whole step (api.runners -> train.trainer)"
UNIT = "%"
BETTER = "higher"
MOVES = "train_tokens_per_s"


def read(r):
    flops = r.timed["model_flops"]
    if not flops:
        return None
    return 100.0 * flops / r.timed["seconds"] / r.peak["bf16_flops"]
