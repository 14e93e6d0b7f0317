"""The port's ``ModelConfig`` held to the reference's: the fields the
reference lacks (Jamba's published maths, an expert-parallel share of
the experts) at the values that keep the reference's maths, and every
other field equal."""
import dataclasses

PORT_ONLY = {"moe_renormalize": True, "expert_shard": (0, 0),
             "mamba_dtbc_norm": False}


def as_reference(cfg) -> dict:
    """``dataclasses.asdict(cfg)`` without the port-only fields, which
    must hold their ``PORT_ONLY`` values."""
    d = dataclasses.asdict(cfg)
    assert {k: d.pop(k) for k in PORT_ONLY} == PORT_ONLY
    return d
