"""The benchmark's frozen arithmetic: the card's peaks, a step's model
FLOPs, the work a kernel's shape needs, and the names of kernel groups.
Copies of the program's formulas where it had them, kept here so that a
change to the program cannot move its own yardstick."""
