"""The share, in percent, of the stretch's kernel time spent in PyTorch's
elementwise kernels (`elementwise_kernel`, `vectorized_elementwise_kernel`,
`unrolled_elementwise_kernel`: the unfused math of the wavefront), its
indexing kernels (`index_elementwise_kernel`, gathers and scatters) left
out."""

from portbench.devtrace import kernel_percent


def elementwise(name: str) -> bool:
    return "elementwise_kernel" in name and "index_elementwise_kernel" not in name


def read(ctx):
    return kernel_percent(ctx.trace, elementwise) if ctx.trace is not None else None
