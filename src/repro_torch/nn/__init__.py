"""Language-model layers: initializer, norms and MLPs, attention (flash
forward, ring-buffer decode), MoE, the Mamba-1 block and the LM assembly
for every architecture in `repro_torch.configs`."""
