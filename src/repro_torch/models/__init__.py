"""The port's model stack, every family of the JAX package: dense GQA,
MLA + MoE, RWKV-6, Hymba and Whisper; parameters as ``nn.Module``s named as
the JAX leaves, the training loss, prefill and greedy decode."""
