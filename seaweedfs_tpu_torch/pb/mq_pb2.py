# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: mq.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x08mq.proto\x12\rweedtpu_mq_pb\".\n\x17\x46indBrokerLeaderRequest\x12\x13\n\x0b\x66iler_group\x18\x01 \x01(\t\"*\n\x18\x46indBrokerLeaderResponse\x12\x0e\n\x06\x62roker\x18\x01 \x01(\t\"R\n\x15\x43onfigureTopicRequest\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\r\n\x05topic\x18\x02 \x01(\t\x12\x17\n\x0fpartition_count\x18\x03 \x01(\x05\"1\n\x16\x43onfigureTopicResponse\x12\x17\n\x0fpartition_count\x18\x01 \x01(\x05\"&\n\x11ListTopicsRequest\x12\x11\n\tnamespace\x18\x01 \x01(\t\"F\n\tTopicInfo\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\r\n\x05topic\x18\x02 \x01(\t\x12\x17\n\x0fpartition_count\x18\x03 \x01(\x05\">\n\x12ListTopicsResponse\x12(\n\x06topics\x18\x01 \x03(\x0b\x32\x18.weedtpu_mq_pb.TopicInfo\"\x18\n\x16\x43heckBrokerLoadRequest\"E\n\x17\x43heckBrokerLoadResponse\x12\x15\n\rmessage_count\x18\x01 \x01(\x03\x12\x13\n\x0b\x62ytes_count\x18\x02 \x01(\x03\"\x96\x01\n\x0ePublishRequest\x12\x37\n\x04init\x18\x01 \x01(\x0b\x32).weedtpu_mq_pb.PublishRequest.InitMessage\x12\x0b\n\x03key\x18\x02 \x01(\t\x12\r\n\x05value\x18\x03 \x01(\x0c\x1a/\n\x0bInitMessage\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\r\n\x05topic\x18\x02 \x01(\t\"I\n\x0fPublishResponse\x12\x14\n\x0c\x61\x63k_sequence\x18\x01 \x01(\x03\x12\x11\n\tpartition\x18\x02 \x01(\x05\x12\r\n\x05\x65rror\x18\x03 \x01(\t\"g\n\x10SubscribeRequest\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\r\n\x05topic\x18\x02 \x01(\t\x12\x11\n\tpartition\x18\x03 \x01(\x05\x12\x0c\n\x04tail\x18\x04 \x01(\x08\x12\x10\n\x08since_ns\x18\x05 \x01(\x03\"c\n\x11SubscribeResponse\x12\r\n\x05ts_ns\x18\x01 \x01(\x03\x12\x0b\n\x03key\x18\x02 \x01(\t\x12\r\n\x05value\x18\x03 \x01(\x0c\x12\x11\n\tpartition\x18\x04 \x01(\x05\x12\x10\n\x08sequence\x18\x05 \x01(\x03\x32\xba\x04\n\x13SeaweedTpuMessaging\x12\x65\n\x10\x46indBrokerLeader\x12&.weedtpu_mq_pb.FindBrokerLeaderRequest\x1a\'.weedtpu_mq_pb.FindBrokerLeaderResponse\"\x00\x12_\n\x0e\x43onfigureTopic\x12$.weedtpu_mq_pb.ConfigureTopicRequest\x1a%.weedtpu_mq_pb.ConfigureTopicResponse\"\x00\x12S\n\nListTopics\x12 .weedtpu_mq_pb.ListTopicsRequest\x1a!.weedtpu_mq_pb.ListTopicsResponse\"\x00\x12\x62\n\x0f\x43heckBrokerLoad\x12%.weedtpu_mq_pb.CheckBrokerLoadRequest\x1a&.weedtpu_mq_pb.CheckBrokerLoadResponse\"\x00\x12N\n\x07Publish\x12\x1d.weedtpu_mq_pb.PublishRequest\x1a\x1e.weedtpu_mq_pb.PublishResponse\"\x00(\x01\x30\x01\x12R\n\tSubscribe\x12\x1f.weedtpu_mq_pb.SubscribeRequest\x1a .weedtpu_mq_pb.SubscribeResponse\"\x00\x30\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'mq_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _FINDBROKERLEADERREQUEST._serialized_start=27
  _FINDBROKERLEADERREQUEST._serialized_end=73
  _FINDBROKERLEADERRESPONSE._serialized_start=75
  _FINDBROKERLEADERRESPONSE._serialized_end=117
  _CONFIGURETOPICREQUEST._serialized_start=119
  _CONFIGURETOPICREQUEST._serialized_end=201
  _CONFIGURETOPICRESPONSE._serialized_start=203
  _CONFIGURETOPICRESPONSE._serialized_end=252
  _LISTTOPICSREQUEST._serialized_start=254
  _LISTTOPICSREQUEST._serialized_end=292
  _TOPICINFO._serialized_start=294
  _TOPICINFO._serialized_end=364
  _LISTTOPICSRESPONSE._serialized_start=366
  _LISTTOPICSRESPONSE._serialized_end=428
  _CHECKBROKERLOADREQUEST._serialized_start=430
  _CHECKBROKERLOADREQUEST._serialized_end=454
  _CHECKBROKERLOADRESPONSE._serialized_start=456
  _CHECKBROKERLOADRESPONSE._serialized_end=525
  _PUBLISHREQUEST._serialized_start=528
  _PUBLISHREQUEST._serialized_end=678
  _PUBLISHREQUEST_INITMESSAGE._serialized_start=631
  _PUBLISHREQUEST_INITMESSAGE._serialized_end=678
  _PUBLISHRESPONSE._serialized_start=680
  _PUBLISHRESPONSE._serialized_end=753
  _SUBSCRIBEREQUEST._serialized_start=755
  _SUBSCRIBEREQUEST._serialized_end=858
  _SUBSCRIBERESPONSE._serialized_start=860
  _SUBSCRIBERESPONSE._serialized_end=959
  _SEAWEEDTPUMESSAGING._serialized_start=962
  _SEAWEEDTPUMESSAGING._serialized_end=1532
# @@protoc_insertion_point(module_scope)
