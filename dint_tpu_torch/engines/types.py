"""Op and reply codes of the dense TATP path (the members of
`dint_tpu.engines.types.Op`/`Reply` that this package uses, same values)."""


class Op:
    NOP = 0
    OCC_READ = 16      # read value + version (no lock)
    OCC_LOCK = 17      # row lock (write-slot arbitration)


class Reply:
    NONE = 0
    GRANT = 1          # lock granted
    REJECT = 2         # no-wait lock reject
    NOT_EXIST = 5      # missing row
    VAL = 6            # read reply carrying value + version
    REJECT_SAME_KEY = 8
