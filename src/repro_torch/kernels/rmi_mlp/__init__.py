from .ops import rmi_mlp_forward, rmi_stage_forward  # noqa: F401
