"""The paper's own §6.2 hyper-representation experiment config: 2-layer
MLP, 200 hidden units; outer = hidden layer (157k params with d=784),
inner = output head (2010 params)."""
N_AGENTS = 10
INPUT_DIM = 784
HIDDEN = 200
N_CLASSES = 10
