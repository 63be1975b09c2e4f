"""The plain reference that decides ``correct``: one module a scheme,
named as a configuration's ``scheme`` (:mod:`.ckks`, :mod:`.bfv`:
decryption, decoding, the control, the comparison and the check the
limits are calibrated on), and one module of plain math a driver,
named as the entry is (``<entry>.expected``).  Imports torch and numpy
only."""
