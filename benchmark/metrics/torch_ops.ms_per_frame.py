"""torch_ops.ms_per_frame (torch ops, ms): device time a frame of the
kernels that PyTorch's own operators launched (an aten:: operator is the
kernel's launching host event), as against the hand-written kernels
launched through ctypes or Triton. None where the trace holds no device
activity."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    s = sum((op.end_ns - op.start_ns) * 1e-9
            for op in ctx.trace.ops if op.torch_op and op.kernel)
    return s * 1e3 / ctx.frames
