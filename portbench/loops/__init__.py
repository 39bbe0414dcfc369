"""The loops of the traffic kinds, one file a kind (the ``kind`` of a
traffic file): each sets up the program, runs its measured window, a
profiled stretch, frees the program, and checks what the window produced."""
