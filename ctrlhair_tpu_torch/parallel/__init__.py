# Data-parallel training of the port: the process group, the batch's rows
# and the collectives (mesh.py), and the multi-rank dry run (dryrun.py).
