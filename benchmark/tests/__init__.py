"""CPU tests of the benchmark harness; tests marked `gpu` run on a card."""
