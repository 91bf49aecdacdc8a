"""Rules: constant tables, the pure-Python oracle and the batched env."""
