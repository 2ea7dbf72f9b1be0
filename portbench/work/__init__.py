"""The yardstick's arithmetic: card peaks, bounds, and the operations and
bytes of each kernel call and of a whole step, from a configuration's
shapes alone.  Imports torch only where it says so."""
