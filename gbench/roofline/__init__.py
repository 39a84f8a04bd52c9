"""The least time the card could take for a piece of work: the larger of
its bytes over the memory rate and its float operations over the float32
rate, from counts of what the work's inputs need (never from the stages
of the kernel that does it)."""
