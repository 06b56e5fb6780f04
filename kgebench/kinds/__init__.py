"""Traffic kinds: ``kinds/<kind>.py`` holds ``run(cell) -> Outcome``, the
one general generator that every traffic mix of that kind parameterises,
``control(cell)``, the compared numbers of the precision control at the
cell's size, and ``FAULTS``, the faults planted in the program that the
kind's ``correct`` has to catch."""
