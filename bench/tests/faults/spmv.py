"""The SpMV op's timed path broken underneath: ``broken(fault)`` gives the
``repro_torch.engine.substrate`` attribute to replace, ``spmv_kernel``, and a
kernel that runs the real one and then breaks its y."""


def broken(fault: str):
    from repro_torch.kernels.spmv.ops import spmv as real

    def spmv(cols, vals, x, grain):
        if fault == "state_unchanged":  # hands its input back as the result
            return x[: cols.shape[0]].clone()
        y = real(cols, vals, x, grain=grain)
        if fault == "half_left_out":
            y[y.shape[0] // 2:] = 0
        elif fault == "answer_altered":
            y[y.shape[0] // 3] += 1.0
        return y

    return "spmv_kernel", spmv
