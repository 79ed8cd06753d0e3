"""The yardstick's frozen arithmetic: the chip's published peaks and the
operations and bytes that a model step or a kernel call needs, computed from
shapes alone.  Nothing here imports the program, so a change to the program
cannot move a share's denominator."""
