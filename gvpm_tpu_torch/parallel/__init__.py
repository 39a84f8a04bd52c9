"""Multi-GPU rendering on torch.distributed (mirrors gvpm_tpu/parallel/).

mesh.py holds a rank's view of the process group and the collectives,
launch.py starts ranks from one process, dist.py holds the sharded SPPM
and G-VPM passes and their progressive loops.
"""
