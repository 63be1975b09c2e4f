"""Near-tie α columns of the fast base conversion, shared by the port's
tests.

Each table lists columns (one S-tuple of source residues a row) where an
fma chain and a multiply-then-add chain round α = Σ_i f32(v_i)·f32(1/p_i)
differently; they were found once by a seeded search.
``tests/test_torch_alpha.py::test_columns_are_ties`` checks every table
against hetpu's jitted α.  This module imports neither JAX nor hetpu, so
the card tests (``tests/test_torch_cuda.py``) use it on a host without
JAX.
"""

# test_dnum, fused tail at the top level: sources q_7 + the 3 specials
TIES_DNUM = [[508039856, 1099080352, 1621637186, 1631625018],
             [37419502, 309566830, 1767178876, 1069488476],
             [454505166, 586600971, 1777398114, 2095414402],
             [92054122, 59180148, 1858753445, 1119026592]]
# test_dnum, the key-switch mod-down: sources the 3 specials (parallel.tp's
# α; the tp tests route them into its sources through a crafted key)
TIES_DNUM_MODDOWN = [[972993366, 762820538, 1485260905],
                     [1441823206, 564645849, 1214607466],
                     [622545832, 540458859, 2058066967],
                     [454748004, 387930481, 231014615]]
# the same sources, ties of the CENTERED values (y_i > q_i/2 → y_i − q_i)
TIES_DNUM_CENTERED = [[362438493, 1635477856, 1308414874, 1699663812],
                      [635511566, 1792818991, 214954608, 2089613811],
                      [832047190, 1506075342, 338069672, 1860156527],
                      [267531152, 2002721513, 383764152, 299512774]]
# N=4096 (four-step tables in hetpu), levels=5, 2 specials: sources of
# the fused tail at level 5
TIES_4096 = [[192642151, 508515651, 179833393],
             [860224061, 1866548870, 1781166677],
             [666931458, 1028692039, 858318483],
             [420010767, 1906473318, 474437857]]
# the same sources, ties of the centered values
TIES_4096_CENTERED = [[183355045, 654948814, 51979694],
                      [330595930, 2080466644, 479292033],
                      [677487970, 1170898094, 695001696],
                      [589129703, 1393233944, 649401248]]
# bench_n14 fused tail at level 8 (q_8 + 5 specials), centered values
TIES_N14_TAIL_CENTERED = [
    [333750730, 1257364962, 1458308631, 1581226189, 1462192700, 1083699233],
    [395601460, 176398552, 1157732102, 1275024936, 1785884804, 177765855],
    [129885377, 2101983350, 1641493074, 1415827326, 410776201, 1681170216],
    [720883104, 510628064, 551053396, 979168627, 614179371, 1265785468]]
