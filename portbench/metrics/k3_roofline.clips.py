"""K3 (csrc/ddim_sampler.cu, float32 on FMAs) against its roofline in the traced slice."""

from portbench.readers import kernel_roofline_pct


def read(ctx):
    return kernel_roofline_pct(ctx, "ddim_sampler", ctx.cfg["denoiser"]["dtype"])
