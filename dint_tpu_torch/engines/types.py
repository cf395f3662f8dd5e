"""Op and reply codes of the dense TATP and SmallBank paths (the members of
`dint_tpu.engines.types.Op`/`Reply` that this package uses, same values),
and the dense engines' kernel routes."""

# route name -> (use_hotset, use_fused) of both dense engines'
# `build_pipelined_runner`
ROUTES = {"default": (False, False), "hotset": (True, False),
          "fused": (False, True), "fused+hotset": (True, True)}


class Op:
    NOP = 0
    ACQ_S_READ = 14    # acquire shared + read value in one RTT
    ACQ_X_READ = 15    # acquire exclusive + read value in one RTT
    OCC_READ = 16      # read value + version (no lock)
    OCC_LOCK = 17      # row lock (write-slot arbitration)


class Reply:
    NONE = 0
    GRANT = 1          # lock granted
    REJECT = 2         # no-wait lock reject
    NOT_EXIST = 5      # missing row
    VAL = 6            # read reply carrying value + version
    REJECT_SAME_KEY = 8
