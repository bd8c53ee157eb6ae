"""Wide & Deep CTR model (Cheng et al. 2016): the port of
``paddle_tpu/models/wide_deep.py:31-101``, building the same programs.

Criteo layout by default: ``num_sparse`` categorical slots (int64 ids
hashed into one shared table space of ``vocab_size`` rows) and
``num_dense`` continuous features.

  * wide: a 1-wide embedding a slot, summed over the slots, plus a linear
    layer on the dense features (a sparse logistic regression);
  * deep: ``embed_dim``-wide embeddings, flattened and concatenated with
    the dense features, through an MLP (``hidden``, relu);
  * logit = wide + deep; loss = sigmoid cross entropy.

With ``is_sparse=True`` (the default) the tables' gradients are
SelectedRows (``framework/selected_rows.py``), which the optimizers apply
to the touched rows where they do so (Adam under ``lazy_mode``).
``is_distributed`` is carried on the lookups as the reference carries it;
training lookups stay in-graph either way.  :func:`wide_deep_serving_net`
is the dense remainder that runs after an embedding tier's gather (the
tier itself, ``serving/embedding.py``, waits for ROADMAP.md queue 1 item
8): fed the gathered rows, it computes the same logit.
"""
from __future__ import annotations

from .. import layers

__all__ = ["wide_deep_net", "wide_deep_serving_net"]


def _wide(wide_sum, dense_x):
    """The wide tower's logit from the slots' summed rows [b, 1]."""
    wide_dense = layers.fc(dense_x, size=1, name="wide_fc")
    return layers.elementwise_add(wide_sum, wide_dense)


def _deep(wide_logit, deep_rows, dense_x, hidden):
    """The deep tower on the looked-up rows, added to the wide logit:
    (logit, prob)."""
    flat = layers.flatten(deep_rows, axis=1)      # [b, num_sparse * dim]
    x = layers.concat([flat, dense_x], axis=1)
    for i, h in enumerate(hidden):
        x = layers.fc(x, size=h, act="relu", name=f"deep_fc{i}")
    deep_logit = layers.fc(x, size=1, name="deep_out")
    logit = layers.elementwise_add(wide_logit, deep_logit)
    return logit, layers.sigmoid(logit)


def wide_deep_net(num_sparse: int = 26, num_dense: int = 13,
                  vocab_size: int = 1000001, embed_dim: int = 10,
                  hidden: tuple = (400, 400, 400),
                  is_sparse: bool = True, is_distributed: bool = False):
    """Build the training program; returns a dict of handles
    (sparse_ids, dense_x, label, logit, prob, loss)."""
    sparse_ids = layers.data("sparse_ids", shape=[num_sparse], dtype="int64",
                             append_batch_size=True)
    dense_x = layers.data("dense_x", shape=[num_dense], dtype="float32",
                          append_batch_size=True)
    label = layers.data("label", shape=[1], dtype="float32",
                        append_batch_size=True)
    wide_emb = layers.embedding(
        sparse_ids, size=[vocab_size, 1], is_sparse=is_sparse,
        is_distributed=is_distributed, name="wide_embedding",
        param_attr="wide_embedding_w")
    wide_logit = _wide(layers.reduce_sum(wide_emb, dim=1), dense_x)
    deep_emb = layers.embedding(
        sparse_ids, size=[vocab_size, embed_dim], is_sparse=is_sparse,
        is_distributed=is_distributed, name="deep_embedding",
        param_attr="deep_embedding_w")
    logit, prob = _deep(wide_logit, deep_emb, dense_x, hidden)
    loss = layers.mean(
        layers.sigmoid_cross_entropy_with_logits(logit, label))
    return {"sparse_ids": sparse_ids, "dense_x": dense_x, "label": label,
            "logit": logit, "prob": prob, "loss": loss}


def wide_deep_serving_net(num_sparse: int = 26, num_dense: int = 13,
                          embed_dim: int = 10,
                          hidden: tuple = (400, 400, 400)):
    """The serving remainder: :func:`wide_deep_net`'s math after the
    lookups, fed the gathered rows, ``wide_rows`` [b, num_sparse, 1] and
    ``deep_rows`` [b, num_sparse, embed_dim].  Returns a dict of handles
    (wide_rows, deep_rows, dense_x, logit, prob)."""
    wide_rows = layers.data("wide_rows", shape=[num_sparse, 1],
                            dtype="float32", append_batch_size=True)
    deep_rows = layers.data("deep_rows", shape=[num_sparse, embed_dim],
                            dtype="float32", append_batch_size=True)
    dense_x = layers.data("dense_x", shape=[num_dense], dtype="float32",
                          append_batch_size=True)
    wide_logit = _wide(layers.reduce_sum(wide_rows, dim=1), dense_x)
    logit, prob = _deep(wide_logit, deep_rows, dense_x, hidden)
    return {"wide_rows": wide_rows, "deep_rows": deep_rows,
            "dense_x": dense_x, "logit": logit, "prob": prob}
