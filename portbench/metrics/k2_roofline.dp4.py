"""K2 (csrc/attention_bwd.cu, bf16, its three passes) against its roofline in the traced slice
on rank 0's card, over that rank's rows of each global step."""

from portbench.readers import kernel_roofline_pct


def read(ctx):
    return kernel_roofline_pct(ctx, "attention_bwd", ctx.cfg["train"]["dtype"])
