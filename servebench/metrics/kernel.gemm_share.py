"""Share of the traced sub-window's device time in matrix-product kernels
(cuBLAS: names holding ``gemm``, ``nvjet``, ``xmma`` or ``cutlass``): the
projections, the MLPs and, in a MoE layer, the experts' products
(``models/moe.py`` runs every expert densely). The device trace of a CUDA
graph replay names each kernel but not the op that launched it, so the
experts' products are not told apart from the other products here."""

GEMM_WORDS = ("gemm", "nvjet", "xmma", "cutlass")


def read(run):
    p = run.profile
    if p is None:
        return None
    total = sum(p.kernels.values())
    gemm = sum(t for name, t in p.kernels.items()
               if any(w in name.lower() for w in GEMM_WORDS))
    return gemm / total if gemm > 0 and total > 0 else None
