from repro_torch.sharding.rules import (
    P,
    batch_pspec,
    data_axis_names,
    distribute,
    param_specs,
    placements,
)
