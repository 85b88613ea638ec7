"""Multi-device solvers on `torch.distributed`, one rank a device: the
body-sharded direct ring (`ring`), the sharded particle mesh (`pmshard`),
the sharded Barnes-Hut tree with its halo exchange (`tree2`), the sharded
TreePM (`treepmshard`), the distributed bitonic sort (`dsort`), the
start-up of a group (`multihost`) and a dry run of the sharded paths
(`dryrun`).

Importing a module here starts no process group and no rank.
"""
