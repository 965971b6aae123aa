"""Token dictionary, automaton assembly, host trie, and the batched
match/decide kernels with their plain PyTorch versions."""
