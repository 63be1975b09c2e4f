"""The plain reference that decides ``correct``: one module a scheme,
named as a configuration's ``scheme`` (:mod:`.ckks`: decryption, decoding,
the control and the comparison), and one module of plain math a driver,
named as the entry is (``<entry>.expected``).  Imports torch and numpy
only."""
