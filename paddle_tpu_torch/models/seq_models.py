"""Sequence models (reference: understand_sentiment + label_semantic_roles
book chapters): conv sentiment net, stacked bi-LSTM sentiment net, and a
stacked-GRU sequence tagger skeleton.

Sequences are padded [B, T] int64 id arrays with a `length` Variable for
mask-aware pooling and recurrence (in place of the reference's LoD)."""

from .. import layers, nets


def convolution_net(data, label, input_dim, class_dim=2, emb_dim=32,
                    hid_dim=32, length=None):
    """Sentiment conv net: embedding -> two sequence_conv_pools -> softmax."""
    emb = layers.embedding(input=data, size=[input_dim, emb_dim],
                           dtype='float32')
    conv_3 = nets.sequence_conv_pool(input=emb, num_filters=hid_dim,
                                     filter_size=3, act='tanh',
                                     pool_type='sqrt', length=length)
    conv_4 = nets.sequence_conv_pool(input=emb, num_filters=hid_dim,
                                     filter_size=4, act='tanh',
                                     pool_type='sqrt', length=length)
    prediction = layers.fc(input=[conv_3, conv_4], size=class_dim,
                           act='softmax')
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=prediction, label=label)
    return prediction, avg_cost, acc


def stacked_lstm_net(data, label, input_dim, class_dim=2, emb_dim=128,
                     hid_dim=512, stacked_num=3, length=None):
    """Stacked alternating-direction LSTM sentiment net (book chapter 06)."""
    assert stacked_num % 2 == 1
    emb = layers.embedding(input=data, size=[input_dim, emb_dim],
                           dtype='float32')
    fc1 = layers.fc(input=emb, size=hid_dim, num_flatten_dims=2)
    lstm1, cell1 = layers.dynamic_lstm(input=fc1, size=hid_dim,
                                       length=length)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = layers.fc(input=inputs, size=hid_dim, num_flatten_dims=2)
        lstm, cell = layers.dynamic_lstm(input=fc, size=hid_dim,
                                         is_reverse=(i % 2) == 0,
                                         length=length)
        inputs = [fc, lstm]
    fc_last = layers.sequence_pool(input=inputs[0], pool_type='max',
                                   length=length)
    lstm_last = layers.sequence_pool(input=inputs[1], pool_type='max',
                                     length=length)
    prediction = layers.fc(input=[fc_last, lstm_last], size=class_dim,
                           act='softmax')
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=prediction, label=label)
    return prediction, avg_cost, acc


def stacked_gru_tagger(word, target, word_dict_len, label_dict_len,
                       emb_dim=32, hidden_dim=128, depth=2, length=None):
    """Simplified SRL-style tagger: embedding -> stacked bi-GRU -> per-step
    softmax over labels (reference label_semantic_roles chapter uses an
    8-feature crf net; the CRF decode layer lives in layers/decode.py)."""
    emb = layers.embedding(input=word, size=[word_dict_len, emb_dim],
                           dtype='float32')
    hidden = layers.fc(input=emb, size=hidden_dim * 3, num_flatten_dims=2)
    for i in range(depth):
        gru = layers.dynamic_gru(input=hidden, size=hidden_dim,
                                 is_reverse=(i % 2) == 1, length=length)
        hidden = layers.fc(input=gru, size=hidden_dim * 3,
                           num_flatten_dims=2)
    feature = layers.fc(input=hidden, size=label_dict_len,
                        num_flatten_dims=2, act=None)
    # per-step cross entropy over the padded grid, masked by length
    probs = layers.softmax(feature)
    cost = layers.cross_entropy(input=probs, label=target)
    avg_cost = layers.mean(cost)
    return feature, avg_cost


def lstm_text_classifier(vocab_size=30000, emb_dim=128, hidden_dim=128,
                         lstm_num=1, class_dim=2, learning_rate=2e-3,
                         l2=8e-4, clip=25.0):
    """The stacked-LSTM IMDB sentiment classifier of the reference's
    benchmark/paddle/rnn config (bench.py's bench_rnn_lstm), as the v1
    trainer_config_helpers shim lowers it to fluid layers: data 'data'
    [B, T] int64 with its length 'data_len' [B] int32, an embedding, per
    LSTM an fc to 4 * hidden_dim without bias and dynamic_lstm over the
    lengths, sequence_last_step, fc(class_dim, softmax), cross_entropy
    against 'label' [B, 1] int64, mean; then element-wise gradient value
    clipping at ``clip`` (the v1 semantics) and Adam(learning_rate) with
    L2Decay(l2). Returns (prediction, avg_cost)."""
    from .. import clip as clip_mod, optimizer, regularizer
    data = layers.data(name='data', shape=[-1], dtype='int64', lod_level=1)
    length = layers.data(name='data_len', shape=[], dtype='int32')
    net = layers.embedding(input=data, size=[vocab_size, emb_dim])
    for _ in range(lstm_num):
        proj = layers.fc(input=net, size=hidden_dim * 4, act=None,
                         bias_attr=False, num_flatten_dims=2)
        net, _ = layers.dynamic_lstm(
            input=proj, size=hidden_dim * 4, is_reverse=False,
            gate_activation='sigmoid', cell_activation='tanh',
            candidate_activation='tanh', length=length)
    last = layers.sequence_last_step(net, length=length)
    prediction = layers.fc(input=last, size=class_dim, act='softmax')
    label = layers.data(name='label', shape=[1], dtype='int64')
    avg_cost = layers.mean(layers.cross_entropy(input=prediction,
                                                label=label))
    clip_mod.set_gradient_clip(clip_mod.GradientClipByValue(max=clip,
                                                            min=-clip))
    optimizer.Adam(learning_rate=learning_rate, beta1=0.9, beta2=0.999,
                   epsilon=1e-8,
                   regularization=regularizer.L2Decay(l2)).minimize(avg_cost)
    return prediction, avg_cost
