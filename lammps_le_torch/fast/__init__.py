from .engine import (  # noqa: F401
    FastState,
    fast_block_reason,
    from_fast,
    make_fast_segment,
    run_fast,
    thermo_row_fast,
    to_fast,
)
