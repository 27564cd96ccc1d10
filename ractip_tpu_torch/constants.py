"""Physical constants and model dimensions of the nearest-neighbor RNA energy model.

Matches the conventions of the reference implementation's thermodynamic stack
(reference src/pf_duplex.c:73 and ViennaRNA energy_const.h): energies are stored
in dekacal/mol (10 cal/mol units) at 37C, and Boltzmann factors are
exp(-E * 10 / kT) with kT in cal/mol.
"""

K0 = 273.15
GASCONST = 1.98717          # cal / (mol K)
TEMP37 = 37.0
KT37 = (TEMP37 + K0) * GASCONST   # ~616.32 cal/mol

INF = 10000000              # forbidden-energy sentinel (dekacal)
TURN = 3                    # minimum hairpin loop size (unpaired bases)
MAXLOOP = 30                # maximum interior/bulge loop size
NBPAIRS = 7                 # pair types: 0=none, 1=CG, 2=GC, 3=GU, 4=UG, 5=AU, 6=UA, 7=NN

# Nucleotide encoding: 0 = padding / unknown, 1=A, 2=C, 3=G, 4=U.
BASES = "NACGU"

# pair_type[a][b] for encoded nucleotides a, b (5' base a pairs 3' base b).
# Same ordering as ViennaRNA's pair matrix (energy tables index by these types).
PAIR_TYPE = [
    #      N  A  C  G  U
    [0, 0, 0, 0, 0],  # N
    [0, 0, 0, 0, 5],  # A:  AU=5
    [0, 0, 0, 1, 0],  # C:  CG=1
    [0, 0, 2, 0, 3],  # G:  GC=2, GU=3
    [0, 6, 0, 4, 0],  # U:  UA=6, UG=4
]

# rtype: type of the reversed pair (i,j) -> (j,i).
RTYPE = [0, 2, 1, 4, 3, 6, 5, 7]

LXC37 = 107.856             # loop-length >30 extrapolation: lxc * ln(size/30)
DUPLEX_INIT = 410           # duplex initiation energy (dekacal), Vienna 1.8 DuplexInit
