# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: filer.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0b\x66iler.proto\x12\x10weedtpu_filer_pb\"\x81\x01\n\x13\x41ssignVolumeRequest\x12\r\n\x05\x63ount\x18\x01 \x01(\x05\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\x12\x0f\n\x07ttl_sec\x18\x04 \x01(\x05\x12\x13\n\x0b\x64\x61ta_center\x18\x05 \x01(\t\x12\x0c\n\x04path\x18\x06 \x01(\t\"\x9d\x01\n\x14\x41ssignVolumeResponse\x12\x0f\n\x07\x66ile_id\x18\x01 \x01(\t\x12\x0b\n\x03url\x18\x02 \x01(\t\x12\x12\n\npublic_url\x18\x03 \x01(\t\x12\r\n\x05\x63ount\x18\x04 \x01(\x05\x12\r\n\x05\x65rror\x18\x05 \x01(\t\x12\x0c\n\x04\x61uth\x18\x06 \x01(\t\x12\x12\n\ncollection\x18\x07 \x01(\t\x12\x13\n\x0breplication\x18\x08 \x01(\t\"+\n\x08Location\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x12\n\npublic_url\x18\x02 \x01(\t\":\n\tLocations\x12-\n\tlocations\x18\x01 \x03(\x0b\x32\x1a.weedtpu_filer_pb.Location\")\n\x13LookupVolumeRequest\x12\x12\n\nvolume_ids\x18\x01 \x03(\t\"\xb9\x01\n\x14LookupVolumeResponse\x12O\n\rlocations_map\x18\x01 \x03(\x0b\x32\x38.weedtpu_filer_pb.LookupVolumeResponse.LocationsMapEntry\x1aP\n\x11LocationsMapEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12*\n\x05value\x18\x02 \x01(\x0b\x32\x1b.weedtpu_filer_pb.Locations:\x02\x38\x01\"=\n\x06\x46ileId\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08\x66ile_key\x18\x02 \x01(\x04\x12\x0e\n\x06\x63ookie\x18\x03 \x01(\x07\"\x87\x01\n\tFileChunk\x12\x0f\n\x07\x66ile_id\x18\x01 \x01(\t\x12\x0e\n\x06offset\x18\x02 \x01(\x03\x12\x0c\n\x04size\x18\x03 \x01(\x04\x12\r\n\x05mtime\x18\x04 \x01(\x03\x12\r\n\x05\x65_tag\x18\x05 \x01(\t\x12\x19\n\x11is_chunk_manifest\x18\x06 \x01(\x08\x12\x12\n\ncipher_key\x18\x07 \x01(\t\"\xe2\x01\n\x0e\x46useAttributes\x12\x11\n\tfile_size\x18\x01 \x01(\x04\x12\r\n\x05mtime\x18\x02 \x01(\x03\x12\x11\n\tfile_mode\x18\x03 \x01(\r\x12\x0b\n\x03uid\x18\x04 \x01(\r\x12\x0b\n\x03gid\x18\x05 \x01(\r\x12\x0e\n\x06\x63rtime\x18\x06 \x01(\x03\x12\x0c\n\x04mime\x18\x07 \x01(\t\x12\x13\n\x0breplication\x18\x08 \x01(\t\x12\x12\n\ncollection\x18\t \x01(\t\x12\x0f\n\x07ttl_sec\x18\n \x01(\x05\x12\x11\n\tuser_name\x18\x0b \x01(\t\x12\x16\n\x0esymlink_target\x18\x0c \x01(\t\"\x9f\x02\n\x05\x45ntry\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x14\n\x0cis_directory\x18\x02 \x01(\x08\x12+\n\x06\x63hunks\x18\x03 \x03(\x0b\x32\x1b.weedtpu_filer_pb.FileChunk\x12\x34\n\nattributes\x18\x04 \x01(\x0b\x32 .weedtpu_filer_pb.FuseAttributes\x12\x37\n\x08\x65xtended\x18\x05 \x03(\x0b\x32%.weedtpu_filer_pb.Entry.ExtendedEntry\x12\x14\n\x0chard_link_id\x18\x07 \x01(\x0c\x12\x0f\n\x07\x63ontent\x18\t \x01(\x0c\x1a/\n\rExtendedEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x0c:\x02\x38\x01\"@\n\tFullEntry\x12\x0b\n\x03\x64ir\x18\x01 \x01(\t\x12&\n\x05\x65ntry\x18\x02 \x01(\x0b\x32\x17.weedtpu_filer_pb.Entry\">\n\x1bLookupDirectoryEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\"F\n\x1cLookupDirectoryEntryResponse\x12&\n\x05\x65ntry\x18\x01 \x01(\x0b\x32\x17.weedtpu_filer_pb.Entry\"\x82\x01\n\x12ListEntriesRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0e\n\x06prefix\x18\x02 \x01(\t\x12\x1c\n\x14start_from_file_name\x18\x03 \x01(\t\x12\x1c\n\x14inclusive_start_from\x18\x04 \x01(\x08\x12\r\n\x05limit\x18\x05 \x01(\r\"=\n\x13ListEntriesResponse\x12&\n\x05\x65ntry\x18\x01 \x01(\x0b\x32\x17.weedtpu_filer_pb.Entry\"O\n\x12\x43reateEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12&\n\x05\x65ntry\x18\x02 \x01(\x0b\x32\x17.weedtpu_filer_pb.Entry\"$\n\x13\x43reateEntryResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"O\n\x12UpdateEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12&\n\x05\x65ntry\x18\x02 \x01(\x0b\x32\x17.weedtpu_filer_pb.Entry\"\x15\n\x13UpdateEntryResponse\"\x83\x01\n\x12\x44\x65leteEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x16\n\x0eis_delete_data\x18\x04 \x01(\x08\x12\x14\n\x0cis_recursive\x18\x05 \x01(\x08\x12\x1e\n\x16ignore_recursive_error\x18\x06 \x01(\x08\"$\n\x13\x44\x65leteEntryResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"l\n\x18\x41tomicRenameEntryRequest\x12\x15\n\rold_directory\x18\x01 \x01(\t\x12\x10\n\x08old_name\x18\x02 \x01(\t\x12\x15\n\rnew_directory\x18\x03 \x01(\t\x12\x10\n\x08new_name\x18\x04 \x01(\t\"\x1b\n\x19\x41tomicRenameEntryResponse\"V\n\x18SubscribeMetadataRequest\x12\x13\n\x0b\x63lient_name\x18\x01 \x01(\t\x12\x13\n\x0bpath_prefix\x18\x02 \x01(\t\x12\x10\n\x08since_ns\x18\x03 \x01(\x03\"~\n\x19SubscribeMetadataResponse\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12?\n\x12\x65vent_notification\x18\x02 \x01(\x0b\x32#.weedtpu_filer_pb.EventNotification\x12\r\n\x05ts_ns\x18\x03 \x01(\x03\"\x9b\x01\n\x11\x45ventNotification\x12*\n\told_entry\x18\x01 \x01(\x0b\x32\x17.weedtpu_filer_pb.Entry\x12*\n\tnew_entry\x18\x02 \x01(\x0b\x32\x17.weedtpu_filer_pb.Entry\x12\x15\n\rdelete_chunks\x18\x03 \x01(\x08\x12\x17\n\x0fnew_parent_path\x18\x04 \x01(\t\"j\n\x14\x41ppendToEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x12\n\nentry_name\x18\x02 \x01(\t\x12+\n\x06\x63hunks\x18\x03 \x03(\x0b\x32\x1b.weedtpu_filer_pb.FileChunk\"&\n\x15\x41ppendToEntryResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"\x17\n\x15\x43ollectionListRequest\"-\n\x16\x43ollectionListResponse\x12\x13\n\x0b\x63ollections\x18\x01 \x03(\t\"-\n\x17\x44\x65leteCollectionRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\"\x1a\n\x18\x44\x65leteCollectionResponse\"2\n\x0bPingRequest\x12\x0e\n\x06target\x18\x01 \x01(\t\x12\x13\n\x0btarget_type\x18\x02 \x01(\t\"S\n\x0cPingResponse\x12\x15\n\rstart_time_ns\x18\x01 \x01(\x03\x12\x16\n\x0eremote_time_ns\x18\x02 \x01(\x03\x12\x14\n\x0cstop_time_ns\x18\x03 \x01(\x03\"I\n&CacheRemoteObjectToLocalClusterRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\"Q\n\'CacheRemoteObjectToLocalClusterResponse\x12&\n\x05\x65ntry\x18\x01 \x01(\x0b\x32\x17.weedtpu_filer_pb.Entry\"\x1b\n\x0cKvGetRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\"-\n\rKvGetResponse\x12\r\n\x05value\x18\x01 \x01(\x0c\x12\r\n\x05\x65rror\x18\x02 \x01(\t\":\n\x0cKvPutRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\r\n\x05value\x18\x02 \x01(\x0c\x12\x0e\n\x06\x64\x65lete\x18\x03 \x01(\x08\"\x1e\n\rKvPutResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"\x13\n\x11StatisticsRequest\"O\n\x12StatisticsResponse\x12\x12\n\ntotal_size\x18\x01 \x01(\x04\x12\x11\n\tused_size\x18\x02 \x01(\x04\x12\x12\n\nfile_count\x18\x03 \x01(\x04\"\x1e\n\x1cGetFilerConfigurationRequest\"z\n\x1dGetFilerConfigurationResponse\x12\x0f\n\x07masters\x18\x01 \x03(\t\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\x12\x0e\n\x06max_mb\x18\x04 \x01(\r\x12\x0f\n\x07version\x18\x05 \x01(\t2\xa7\x0f\n\x0cSeaweedFiler\x12w\n\x14LookupDirectoryEntry\x12-.weedtpu_filer_pb.LookupDirectoryEntryRequest\x1a..weedtpu_filer_pb.LookupDirectoryEntryResponse\"\x00\x12^\n\x0bListEntries\x12$.weedtpu_filer_pb.ListEntriesRequest\x1a%.weedtpu_filer_pb.ListEntriesResponse\"\x00\x30\x01\x12\\\n\x0b\x43reateEntry\x12$.weedtpu_filer_pb.CreateEntryRequest\x1a%.weedtpu_filer_pb.CreateEntryResponse\"\x00\x12\\\n\x0bUpdateEntry\x12$.weedtpu_filer_pb.UpdateEntryRequest\x1a%.weedtpu_filer_pb.UpdateEntryResponse\"\x00\x12\\\n\x0b\x44\x65leteEntry\x12$.weedtpu_filer_pb.DeleteEntryRequest\x1a%.weedtpu_filer_pb.DeleteEntryResponse\"\x00\x12n\n\x11\x41tomicRenameEntry\x12*.weedtpu_filer_pb.AtomicRenameEntryRequest\x1a+.weedtpu_filer_pb.AtomicRenameEntryResponse\"\x00\x12_\n\x0c\x41ssignVolume\x12%.weedtpu_filer_pb.AssignVolumeRequest\x1a&.weedtpu_filer_pb.AssignVolumeResponse\"\x00\x12_\n\x0cLookupVolume\x12%.weedtpu_filer_pb.LookupVolumeRequest\x1a&.weedtpu_filer_pb.LookupVolumeResponse\"\x00\x12p\n\x11SubscribeMetadata\x12*.weedtpu_filer_pb.SubscribeMetadataRequest\x1a+.weedtpu_filer_pb.SubscribeMetadataResponse\"\x00\x30\x01\x12u\n\x16SubscribeLocalMetadata\x12*.weedtpu_filer_pb.SubscribeMetadataRequest\x1a+.weedtpu_filer_pb.SubscribeMetadataResponse\"\x00\x30\x01\x12\x62\n\rAppendToEntry\x12&.weedtpu_filer_pb.AppendToEntryRequest\x1a\'.weedtpu_filer_pb.AppendToEntryResponse\"\x00\x12\x65\n\x0e\x43ollectionList\x12\'.weedtpu_filer_pb.CollectionListRequest\x1a(.weedtpu_filer_pb.CollectionListResponse\"\x00\x12k\n\x10\x44\x65leteCollection\x12).weedtpu_filer_pb.DeleteCollectionRequest\x1a*.weedtpu_filer_pb.DeleteCollectionResponse\"\x00\x12G\n\x04Ping\x12\x1d.weedtpu_filer_pb.PingRequest\x1a\x1e.weedtpu_filer_pb.PingResponse\"\x00\x12\x98\x01\n\x1f\x43\x61\x63heRemoteObjectToLocalCluster\x12\x38.weedtpu_filer_pb.CacheRemoteObjectToLocalClusterRequest\x1a\x39.weedtpu_filer_pb.CacheRemoteObjectToLocalClusterResponse\"\x00\x12J\n\x05KvGet\x12\x1e.weedtpu_filer_pb.KvGetRequest\x1a\x1f.weedtpu_filer_pb.KvGetResponse\"\x00\x12J\n\x05KvPut\x12\x1e.weedtpu_filer_pb.KvPutRequest\x1a\x1f.weedtpu_filer_pb.KvPutResponse\"\x00\x12Y\n\nStatistics\x12#.weedtpu_filer_pb.StatisticsRequest\x1a$.weedtpu_filer_pb.StatisticsResponse\"\x00\x12z\n\x15GetFilerConfiguration\x12..weedtpu_filer_pb.GetFilerConfigurationRequest\x1a/.weedtpu_filer_pb.GetFilerConfigurationResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'filer_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _LOOKUPVOLUMERESPONSE_LOCATIONSMAPENTRY._options = None
  _LOOKUPVOLUMERESPONSE_LOCATIONSMAPENTRY._serialized_options = b'8\001'
  _ENTRY_EXTENDEDENTRY._options = None
  _ENTRY_EXTENDEDENTRY._serialized_options = b'8\001'
  _ASSIGNVOLUMEREQUEST._serialized_start=34
  _ASSIGNVOLUMEREQUEST._serialized_end=163
  _ASSIGNVOLUMERESPONSE._serialized_start=166
  _ASSIGNVOLUMERESPONSE._serialized_end=323
  _LOCATION._serialized_start=325
  _LOCATION._serialized_end=368
  _LOCATIONS._serialized_start=370
  _LOCATIONS._serialized_end=428
  _LOOKUPVOLUMEREQUEST._serialized_start=430
  _LOOKUPVOLUMEREQUEST._serialized_end=471
  _LOOKUPVOLUMERESPONSE._serialized_start=474
  _LOOKUPVOLUMERESPONSE._serialized_end=659
  _LOOKUPVOLUMERESPONSE_LOCATIONSMAPENTRY._serialized_start=579
  _LOOKUPVOLUMERESPONSE_LOCATIONSMAPENTRY._serialized_end=659
  _FILEID._serialized_start=661
  _FILEID._serialized_end=722
  _FILECHUNK._serialized_start=725
  _FILECHUNK._serialized_end=860
  _FUSEATTRIBUTES._serialized_start=863
  _FUSEATTRIBUTES._serialized_end=1089
  _ENTRY._serialized_start=1092
  _ENTRY._serialized_end=1379
  _ENTRY_EXTENDEDENTRY._serialized_start=1332
  _ENTRY_EXTENDEDENTRY._serialized_end=1379
  _FULLENTRY._serialized_start=1381
  _FULLENTRY._serialized_end=1445
  _LOOKUPDIRECTORYENTRYREQUEST._serialized_start=1447
  _LOOKUPDIRECTORYENTRYREQUEST._serialized_end=1509
  _LOOKUPDIRECTORYENTRYRESPONSE._serialized_start=1511
  _LOOKUPDIRECTORYENTRYRESPONSE._serialized_end=1581
  _LISTENTRIESREQUEST._serialized_start=1584
  _LISTENTRIESREQUEST._serialized_end=1714
  _LISTENTRIESRESPONSE._serialized_start=1716
  _LISTENTRIESRESPONSE._serialized_end=1777
  _CREATEENTRYREQUEST._serialized_start=1779
  _CREATEENTRYREQUEST._serialized_end=1858
  _CREATEENTRYRESPONSE._serialized_start=1860
  _CREATEENTRYRESPONSE._serialized_end=1896
  _UPDATEENTRYREQUEST._serialized_start=1898
  _UPDATEENTRYREQUEST._serialized_end=1977
  _UPDATEENTRYRESPONSE._serialized_start=1979
  _UPDATEENTRYRESPONSE._serialized_end=2000
  _DELETEENTRYREQUEST._serialized_start=2003
  _DELETEENTRYREQUEST._serialized_end=2134
  _DELETEENTRYRESPONSE._serialized_start=2136
  _DELETEENTRYRESPONSE._serialized_end=2172
  _ATOMICRENAMEENTRYREQUEST._serialized_start=2174
  _ATOMICRENAMEENTRYREQUEST._serialized_end=2282
  _ATOMICRENAMEENTRYRESPONSE._serialized_start=2284
  _ATOMICRENAMEENTRYRESPONSE._serialized_end=2311
  _SUBSCRIBEMETADATAREQUEST._serialized_start=2313
  _SUBSCRIBEMETADATAREQUEST._serialized_end=2399
  _SUBSCRIBEMETADATARESPONSE._serialized_start=2401
  _SUBSCRIBEMETADATARESPONSE._serialized_end=2527
  _EVENTNOTIFICATION._serialized_start=2530
  _EVENTNOTIFICATION._serialized_end=2685
  _APPENDTOENTRYREQUEST._serialized_start=2687
  _APPENDTOENTRYREQUEST._serialized_end=2793
  _APPENDTOENTRYRESPONSE._serialized_start=2795
  _APPENDTOENTRYRESPONSE._serialized_end=2833
  _COLLECTIONLISTREQUEST._serialized_start=2835
  _COLLECTIONLISTREQUEST._serialized_end=2858
  _COLLECTIONLISTRESPONSE._serialized_start=2860
  _COLLECTIONLISTRESPONSE._serialized_end=2905
  _DELETECOLLECTIONREQUEST._serialized_start=2907
  _DELETECOLLECTIONREQUEST._serialized_end=2952
  _DELETECOLLECTIONRESPONSE._serialized_start=2954
  _DELETECOLLECTIONRESPONSE._serialized_end=2980
  _PINGREQUEST._serialized_start=2982
  _PINGREQUEST._serialized_end=3032
  _PINGRESPONSE._serialized_start=3034
  _PINGRESPONSE._serialized_end=3117
  _CACHEREMOTEOBJECTTOLOCALCLUSTERREQUEST._serialized_start=3119
  _CACHEREMOTEOBJECTTOLOCALCLUSTERREQUEST._serialized_end=3192
  _CACHEREMOTEOBJECTTOLOCALCLUSTERRESPONSE._serialized_start=3194
  _CACHEREMOTEOBJECTTOLOCALCLUSTERRESPONSE._serialized_end=3275
  _KVGETREQUEST._serialized_start=3277
  _KVGETREQUEST._serialized_end=3304
  _KVGETRESPONSE._serialized_start=3306
  _KVGETRESPONSE._serialized_end=3351
  _KVPUTREQUEST._serialized_start=3353
  _KVPUTREQUEST._serialized_end=3411
  _KVPUTRESPONSE._serialized_start=3413
  _KVPUTRESPONSE._serialized_end=3443
  _STATISTICSREQUEST._serialized_start=3445
  _STATISTICSREQUEST._serialized_end=3464
  _STATISTICSRESPONSE._serialized_start=3466
  _STATISTICSRESPONSE._serialized_end=3545
  _GETFILERCONFIGURATIONREQUEST._serialized_start=3547
  _GETFILERCONFIGURATIONREQUEST._serialized_end=3577
  _GETFILERCONFIGURATIONRESPONSE._serialized_start=3579
  _GETFILERCONFIGURATIONRESPONSE._serialized_end=3701
  _SEAWEEDFILER._serialized_start=3704
  _SEAWEEDFILER._serialized_end=5663
# @@protoc_insertion_point(module_scope)
