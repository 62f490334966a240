"""The paper's own four benchmark workloads (Section VI); a copy of
``repro/configs/paper_models.py``, so the port needs nothing of the JAX
package.

Linear / Logistic Regression: d features, batch B, one weight vector.
NN: 784 -> 128 -> 128 -> 10 with ReLU + smx output (Section VI-A c).
CNN: the [4]-style network with the convolution replaced by a fully
connected layer (the paper *overestimates* the same way): 784 -> 980 ->
100 -> 10.

These run through nn/mlp-style layers directly (see train/paper_ml.py),
not the transformer stack.
"""

LINREG = {"kind": "linreg", "features": 784, "layers": ()}
LOGREG = {"kind": "logreg", "features": 784, "layers": ()}
NN = {"kind": "nn", "features": 784, "layers": (128, 128, 10)}
CNN = {"kind": "cnn", "features": 784, "layers": (980, 100, 10)}

BATCHES = (128, 256, 512)
FEATURE_GRID = (10, 100, 1000)

# Real-dataset feature counts for the prediction benchmarks (Table VIII)
PREDICTION_DATASETS = {
    "BT": 14, "WR": 31, "CI": 74,        # linear regression
    "CD": 13, "EP": 179, "RE": 680,      # logistic regression
    "MNIST": 784,                        # NN / CNN
}
