"""K1 (csrc/attention_fwd.cu, bf16) against its roofline in the traced slice."""

from portbench.readers import kernel_roofline_pct


def read(ctx):
    return kernel_roofline_pct(ctx, "attention_fwd", ctx.cfg["ast"]["dtype"])
