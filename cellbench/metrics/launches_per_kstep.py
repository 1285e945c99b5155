"""``launches_per_kstep`` (backend and pass schedule, the program's
``ops.cuda_stencil.launches``): stencil kernel launches per 1000 owned
steps over the window, in this process (rank 0's in a world), warm-up
launches included."""


def read(run):
    steps = sum(u["k"] for u in run.units)
    launches = sum(v for k, v in run.counters.items()
                   if k.startswith("launches."))
    if not steps or not launches:
        return None
    return launches / (steps / 1000)
