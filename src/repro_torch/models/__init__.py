"""The MLA + MoE language model of slice 4 (DeepSeek V2/V3): parameters as
``nn.Module``s named as the JAX leaves, prefill and greedy decode."""
