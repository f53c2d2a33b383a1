"""The deck front end (``lammps_le_tpu/deck``): the LAMMPS-command parser,
the script interpreter and the runner that drives a deck on the card or
the CPU."""

from .parser import Deck, parse_deck, parse_file  # noqa: F401
from .runner import DeckError, DeckRunner  # noqa: F401
