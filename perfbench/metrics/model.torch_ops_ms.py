"""model.torch_ops_ms: device ms of the traced window in operations that
are no hand-written kernel (cuBLAS, cuDNN, PyTorch's own kernels, copies),
per train step."""
from pbcore.layers import csrc_kernels
from pbcore.trace import kernel_name


def read(run):
    if run.get("trace") is None or not run["train_steps"]:
        return None
    mine = csrc_kernels()
    other = sum(s for op, s in run["trace"]["by_op"] if kernel_name(op) not in mine)
    return 1e3 * other / run["train_steps"]
