"""CPU tests of the benchmark; `gpu` cases run on the card."""
