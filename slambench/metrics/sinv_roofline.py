"""The S-inverse set's share of its roofline: the least time of its
launches (S of 2F rows in, S^-1 out; the used rows' SPD inverse) over the
profiled device time of its ``sinv_*`` kernels."""

from slambench import roofline

KERNELS = ("sinv_",)


def read(trace):
    ran = trace.kernels(KERNELS)
    if not ran:
        return None
    spent = sum(i.end - i.start for i in ran) / 1e9
    M = 2 * trace.n_slots
    least = 0.0
    for step in trace.used_rows:
        for phase in (0, 1):
            least += roofline.bound_s(
                sum(roofline.sinv_bytes(M) for _ in step),
                sum(roofline.sinv_flops(rows[phase]) for rows in step))
    return 100.0 * least / spent
