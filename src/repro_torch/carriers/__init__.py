"""The DTensor carriers of the distributed routes: the D-sharded (K, D)
stack of the flat trainer (``columns``) and the placed leaf of the tree
trainer under a mesh (``placed``). Their work runs on local blocks, their
gathers and sums go in rank order. They import no trainer and no
registry, so the aggregators of ``repro_torch.core`` and the layers of
``repro_torch.distributed`` both build on them."""
