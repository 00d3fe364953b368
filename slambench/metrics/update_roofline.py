"""The fused joint update's share of its roofline: the least time of its
launches (slambench/roofline.py, counted from the rows each launch used)
over the profiled device time of its three kernels (update_factor,
update_solve, update_downdate, batched or not)."""

from slambench import roofline

KERNELS = ("update_factor", "update_solve", "update_downdate")


def read(trace):
    ran = trace.kernels(KERNELS)
    if not ran:
        return None
    spent = sum(i.end - i.start for i in ran) / 1e9
    N, F = trace.n_state, trace.n_slots
    least = 0.0
    for step in trace.used_rows:
        for phase in (0, 1):
            least += roofline.bound_s(
                sum(roofline.update_bytes(N, F, rows[phase]) for rows in step),
                sum(roofline.update_flops(N, rows[phase]) for rows in step))
    return 100.0 * least / spent
