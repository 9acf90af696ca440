"""Set-up: the seconds of the CLI's ``build_models`` (the span
``models.build`` of the program's process clock ``utils.profiling.TRACE``),
which the harness's set-up calls once before it loads the seeded weights."""


def read(r):
    try:
        from eva_vos_tpu_torch.utils.profiling import TRACE
    except ImportError:
        return None
    return TRACE.totals.get("models.build")
