"""Multi-device solvers on `torch.distributed`, one rank a device: the
body-sharded direct ring (`ring`), the sharded particle mesh (`pmshard`),
the distributed bitonic sort (`dsort`), the start-up of a group
(`multihost`) and a dry run of the sharded paths (`dryrun`).

Importing a module here starts no process group and no rank.
"""

#: where the refusals of what the next slice ports (the sharded tree and
#: TreePM, the pool forms of the near lists) point
ITEM_11B = "ROADMAP.md Queue A item 11b"
