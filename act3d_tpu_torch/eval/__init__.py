"""Closed-loop evaluation: the chained keypose -> trajectory Actioner, the
RLBench loop over a simulator or its sim-free stand-in, the eval CLI
(``main``) and the real-robot loop."""
