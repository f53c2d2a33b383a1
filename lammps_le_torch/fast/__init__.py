from .engine import (  # noqa: F401
    FastState,
    fast_block_reason,
    fast_supported,
    from_fast,
    make_fast_segment,
    replica,
    run_fast,
    run_fast_replicas,
    stack_fast,
    thermo_row_fast,
    to_fast,
)
