"""Share of the port's K2/K3 launches that found their launch plan built
(``repro_torch.kernels._build.plans``, plans built by kernel, against
``launches`` of the same kernels), over the process, %. A program without
the counter reads None, as does one that launched no planned kernel."""


def read(run):
    try:
        from repro_torch.kernels import _build
    except ImportError:
        return None
    plans = getattr(_build, "plans", None)
    if plans is None:
        return None
    built = plans.snapshot()
    launched = sum(_build.launches.get(k) for k in built)
    if not launched:
        return None
    return 100.0 * (1.0 - sum(built.values()) / launched)
