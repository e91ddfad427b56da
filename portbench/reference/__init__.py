"""The plain reference: the A2 cmlp generator (branched, and its deploy
fold), chamfer, the auction EMD, the annealed Sinkhorn loss, batched ICP
and Adam, in plain PyTorch. It imports nothing of the program under test and
works out from the benchmark's own inputs whatever the program derives."""
