"""Share of the card's memory roofline that the preconditioner reaches:
the least time its applications in the traced solves could take (the
bytes roofline.precond_bytes counts for one application, times the
applications, over the peak rate) over the device time of all the work
launched while one was open (the profiler's trace)."""


def read(r):
    calls = r.trace.get("calls", {}).get("precond", 0)
    busy = r.trace.get("device_s", {}).get("precond", 0.0)
    if not calls or busy <= 0.0 or not r.precond_bytes:
        return None
    return 100.0 * calls * r.precond_bytes / r.hbm_bytes_s / busy
