"""Personalized recommendation: the dual-tower embedding model on the
MovieLens schema (reference: paddle_tpu models/recommender.py; the
recommender_system book chapter). A user tower (id, gender, age, job
embeddings -> fc tanh) and a movie tower (id, category embeddings -> fc
tanh), their cosine similarity scaled to the rating range, regressed
against the observed score. Its tables are dense (no ``is_sparse``)."""

from .. import layers


def _tower(ids_and_sizes, emb_dim, out_dim, name):
    feats = []
    for i, (var, vocab) in enumerate(ids_and_sizes):
        feats.append(layers.embedding(
            input=var, size=[vocab, emb_dim], dtype='float32',
            param_attr='%s_emb_%d' % (name, i)))
    return layers.fc(input=layers.concat(feats, axis=1)
                     if len(feats) > 1 else feats[0],
                     size=out_dim, act='tanh', param_attr='%s_fc.w' % name)


def recommender(user_vocab=944, gender_vocab=2, age_vocab=7,
                job_vocab=21, movie_vocab=1683, category_vocab=19,
                emb_dim=32, fc_dim=200, max_rating=5.0):
    """Returns (predicted_score, avg_cost). Feeds (all [B, 1] int64
    except score): uid, gender, age, job, mov_id, category, score
    [B, 1] float32."""
    uid = layers.data(name='uid', shape=[1], dtype='int64')
    gender = layers.data(name='gender', shape=[1], dtype='int64')
    age = layers.data(name='age', shape=[1], dtype='int64')
    job = layers.data(name='job', shape=[1], dtype='int64')
    mov_id = layers.data(name='mov_id', shape=[1], dtype='int64')
    category = layers.data(name='category', shape=[1], dtype='int64')
    score = layers.data(name='score', shape=[1], dtype='float32')

    usr = _tower([(uid, user_vocab), (gender, gender_vocab),
                  (age, age_vocab), (job, job_vocab)],
                 emb_dim, fc_dim, 'usr')
    mov = _tower([(mov_id, movie_vocab), (category, category_vocab)],
                 emb_dim, fc_dim, 'mov')

    sim = layers.cos_sim(X=usr, Y=mov)
    pred = layers.scale(sim, scale=max_rating)
    cost = layers.square_error_cost(input=pred, label=score)
    avg_cost = layers.mean(cost)
    return pred, avg_cost
