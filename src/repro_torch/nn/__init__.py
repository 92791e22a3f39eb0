"""Language-model layers: norms and initializers, the Mamba-1 block and
the pure-Mamba LM assembly."""
