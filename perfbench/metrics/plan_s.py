"""Host seconds of `build_gnn` (advisor, tuner, partition, schedules on
the device), closed by a synchronise: the benchmark's own clock."""


def read(run):
    return run.plan_s
